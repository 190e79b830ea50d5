"""The port's raw -> WAI conversion against the JAX package's, on the CPU.

``data_processing/conversion`` (formats, the 15 adapters, the scene writer and
scene loop), ``aggregate`` and ``tools/convert_wai.py`` against
``scripts/convert_wai.py``, on synthetic raw trees made from numpy seeds (the
BlendedMVS and TartanAir layouts are the JAX tests' own). Both packages read
the same numpy files, so the adapters' records must be equal: frame names,
sizes, intrinsics, poses and depth exactly, images equal as paths or pixels.
The two WAI trees hold the same files and equal ``scene_meta.json``; images
hold equal pixels (the port writes PNGs with its own encoder: the bytes may
differ), EXR depth is exactly equal, and covisibility agrees within 2e-3
absolute off the diagonal (the JAX package jits one XLA program, the port runs
torch ops; the count of differing entries is recorded); on the diagonal, a
view against itself, within one border row and column of its pixels, (h + w)
/ (h w), where the reprojected border lands exactly on the image border and
float32 rounding alone decides. Covisibility runs with ``--device cpu`` here.
"""

import gzip
import importlib.util
import json
from pathlib import Path

import cv2
import h5py
import numpy as np
import pytest

from mapanything_tpu.data_processing import aggregate as jax_aggregate
from mapanything_tpu.data_processing import conversion as jax_conv
from mapanything_tpu.data_processing.conversion import adapters as jax_adapters
from mapanything_tpu.data_processing.conversion import formats as jax_formats
from mapanything_tpu_torch.data import wai as port_wai
from mapanything_tpu_torch.data_processing import aggregate as port_aggregate
from mapanything_tpu_torch.data_processing import conversion as port_conv
from mapanything_tpu_torch.data_processing.conversion import adapters as port_adapters
from mapanything_tpu_torch.data_processing.conversion import formats as port_formats
from mapanything_tpu_torch.tools import convert_wai as port_convert_wai
from mapanything_tpu_torch.utils import threads
from mapanything_tpu_torch.utils.exr import read_depth_exr, write_depth_exr
from test_conversion import _make_blendedmvs_raw, _make_tav2_raw

lean_module = pytest.fixture(scope="module", autouse=True)(threads.lean_module)

ROOT = Path(__file__).resolve().parents[1]
COVIS_ATOL = 2e-3
H, W = 12, 16


def rng_image(rng, h=H, w=W):
    return rng.randint(0, 255, (h, w, 3), np.uint8)


def write_png(path, img):
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    assert cv2.imwrite(str(path), img)


def K_rows(f=20.0):
    return np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]])


# ---------------------------------------------------------------- formats


def pfm_file(tmp, color):
    rng = np.random.RandomState(3)
    data = rng.uniform(0.5, 4, (5, 7, 3) if color else (5, 7)).astype("<f4")
    path = tmp / f"d{int(color)}.pfm"
    path.write_bytes((b"PF\n" if color else b"Pf\n") + b"7 5\n-1.0\n" + data[::-1].tobytes())
    return (path,)


def float16_png(tmp):
    depth = np.random.RandomState(4).uniform(0.1, 9, (H, W)).astype(np.float16)
    write_png(tmp / "f16.png", depth.view(np.uint16))
    return (tmp / "f16.png",)


def dsp5_file(tmp):
    with h5py.File(tmp / "d.dsp5", "w") as f:
        f["disparity"] = np.random.RandomState(5).uniform(0, 30, (8, 10)).astype(np.float32)
    return (tmp / "d.dsp5",)


def transforms_json(tmp, shared):
    rng = np.random.RandomState(6)
    frames = [{"file_path": f"images/frame_{i:05d}.png", "transform_matrix": np.eye(4) + 0.1 * rng.randn(4, 4)}
              for i in range(3)]
    meta = {"frames": [{**fr, "transform_matrix": fr["transform_matrix"].tolist()} for fr in frames]}
    cam = {"fl_x": 21.0, "fl_y": 22.5, "cx": 8.1, "cy": 5.9, "w": W, "h": H}
    if shared:
        meta.update(cam, k1=0.01, k2=-0.002, p1=0.0005, p2=0.0)
    else:
        for fr in meta["frames"]:
            fr.update(cam)
    (tmp / f"t{int(shared)}.json").write_text(json.dumps(meta))
    return (tmp / f"t{int(shared)}.json",)


def viewpoint():
    rng = np.random.RandomState(7)
    q, _ = np.linalg.qr(rng.randn(3, 3))
    return {"focal_length": [1.7, 1.8], "principal_point": [0.05, -0.03], "R": q.tolist(), "T": rng.randn(3).tolist()}


FORMAT_CASES = {
    "pfm_grey": ("read_pfm", lambda tmp: pfm_file(tmp, False)),
    "pfm_color": ("read_pfm", lambda tmp: pfm_file(tmp, True)),
    "float16_png": ("read_float16_png_depth", float16_png),
    "dsp5": ("read_dsp5_disparity", dsp5_file),
    "disparity": ("disparity_to_depth", lambda tmp: (np.random.RandomState(8).uniform(-1, 20, (6, 9)), 35.0, 0.1, 8.0)),
    "gta_ndc": ("gta_ndc_depth_to_camera", lambda tmp: (np.random.RandomState(9).uniform(1e-4, 0.1, (6, 9)),
                                                        np.linalg.inv(np.diag([1.2, 1.5, -1.01, 1.0]) + 0.01))),
    "gl2cv": ("gl2cv_pose", lambda tmp: (np.random.RandomState(10).randn(4, 4),)),
    "w2c_to_c2w": ("w2c_to_c2w", lambda tmp: (np.linalg.qr(np.random.RandomState(11).randn(4, 4))[0],)),
    "quat_xyzw": ("quat_xyzw_to_matrix", lambda tmp: (np.random.RandomState(12).randn(4),)),
    "quat_wxyz": ("quat_wxyz_to_matrix", lambda tmp: (np.random.RandomState(13).randn(4),)),
    "axis_angle": ("axis_angle_to_matrix", lambda tmp: (np.random.RandomState(14).randn(3),)),
    "axis_angle_zero": ("axis_angle_to_matrix", lambda tmp: (np.zeros(3),)),
    "pytorch3d": ("pytorch3d_ndc_camera_to_opencv", lambda tmp: (viewpoint(), (W, H))),
    "nerfstudio_shared": ("read_nerfstudio_transforms", lambda tmp: transforms_json(tmp, True)),
    "nerfstudio_per_frame": ("read_nerfstudio_transforms", lambda tmp: transforms_json(tmp, False)),
}


def assert_same(a, b, where=""):
    """Equal values: arrays exactly (NaN where NaN), dicts and sequences item by item."""
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (where, a.shape, b.shape, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, (where, a, b)


@pytest.mark.parametrize("name", sorted(FORMAT_CASES))
def test_format_matches_jax(name, tmp_path):
    fn, make = FORMAT_CASES[name]
    args = make(tmp_path)
    assert_same(getattr(port_formats, fn)(*args), getattr(jax_formats, fn)(*args), name)


# ---------------------------------------------------------------- adapters


def make_mvs_synth(root):
    rng = np.random.RandomState(20)
    scene = root / "0000"
    for i in range(3):
        n = f"{i:04d}"
        write_png(scene / "images" / f"{n}.png", rng_image(rng))
        d = rng.uniform(10, 50, (H, W)).astype(np.float32)
        d[0, :3] = np.inf
        (scene / "depths").mkdir(parents=True, exist_ok=True)
        write_depth_exr(scene / "depths" / f"{n}.exr", d)
        (scene / "poses").mkdir(exist_ok=True)
        cam = {"f_x": 20.0, "f_y": 21.0, "c_x": 8.0, "c_y": 6.0, "extrinsic": (np.eye(4) + 0.05 * rng.randn(4, 4)).tolist()}
        (scene / "poses" / f"{n}.json").write_text(json.dumps(cam))


def make_unrealstereo(root):
    rng = np.random.RandomState(21)
    scene = root / "Scene0"
    for stem in ("00000", "00001"):
        for c in (0, 1):
            write_png(scene / f"Image{c}" / f"{stem}.png", rng_image(rng))
            (scene / f"Disp{c}").mkdir(parents=True, exist_ok=True)
            np.save(scene / f"Disp{c}" / f"{stem}.npy", rng.uniform(0.1, 20, (H, W)).astype(np.float32))
            (scene / f"Extrinsics{c}").mkdir(parents=True, exist_ok=True)
            e = np.eye(4)[:3] + 0.05 * rng.randn(3, 4)
            e[0, 3] += 0.5 * c
            (scene / f"Extrinsics{c}" / f"{stem}.txt").write_text(
                " ".join(map(str, K_rows().ravel())) + "\n" + " ".join(map(str, e.ravel())) + "\n")


def make_spring(root):
    rng = np.random.RandomState(22)
    scene = root / "train" / "0001"
    (scene / "cam_data").mkdir(parents=True)
    np.savetxt(scene / "cam_data" / "intrinsics.txt", [[20, 21, 8, 6], [20.5, 21, 8, 6]])
    np.savetxt(scene / "cam_data" / "extrinsics.txt", (np.eye(4)[None] + 0.05 * rng.randn(2, 4, 4)).reshape(2, 16))
    for num in ("0001", "0002"):
        for side in ("left", "right"):
            write_png(scene / f"frame_{side}" / f"frame_{side}_{num}.png", rng_image(rng))
            (scene / f"disp1_{side}").mkdir(exist_ok=True)
            with h5py.File(scene / f"disp1_{side}" / f"disp1_{side}_{num}.dsp5", "w") as f:
                f["disparity"] = rng.uniform(0, 20, (2 * H, 2 * W)).astype(np.float32)
        write_png(scene / "maps" / "skymap_left" / f"skymap_left_{num}.png", (rng.rand(H, W) > 0.5).astype(np.uint8) * 255)


def make_eth3d(root):
    rng = np.random.RandomState(23)
    scene = root / "courtyard"
    calib = scene / "dslr_calibration_undistorted"
    calib.mkdir(parents=True)
    (calib / "cameras.txt").write_text(f"# cams\n0 PINHOLE {W} {H} 20 21 8 6\n")
    lines = ["# images"]
    for i, name in enumerate(("DSC_0001.JPG", "DSC_0002.JPG")):
        q = rng.randn(4)
        q /= np.linalg.norm(q)
        lines.append(f"{i + 1} {' '.join(map(str, q))} {' '.join(map(str, rng.randn(3)))} 0 dslr_images_undistorted/{name}")
        lines.append("1.0 2.0 -1")
        write_png(scene / "images" / "dslr_images_undistorted" / name, rng_image(rng))
        (scene / "ground_truth_depth" / "dslr_images").mkdir(parents=True, exist_ok=True)
        d = rng.uniform(1, 9, (H, W)).astype("<f4")
        d[0, 0] = np.inf
        d.tofile(scene / "ground_truth_depth" / "dslr_images" / name)
    (calib / "images.txt").write_text("\n".join(lines) + "\n")


def make_dl3dv(root):
    rng = np.random.RandomState(24)
    scene = root / "abc123"
    scene.mkdir(parents=True)
    (scene / "transforms.json").write_text(transforms_json(scene, True)[0].read_text())
    for i in range(3):
        write_png(scene / "images" / f"frame_{i:05d}.png", rng_image(rng))


def make_scannetpp(root):
    rng = np.random.RandomState(25)
    dslr = root / "0a5c013435" / "dslr"
    (dslr / "nerfstudio").mkdir(parents=True)
    (dslr / "nerfstudio" / "transforms.json").write_text(transforms_json(dslr, False)[0].read_text())
    for i in range(3):
        write_png(dslr / "resized_images" / "images" / f"frame_{i:05d}.png", rng_image(rng))
        write_png(dslr / "render_depth" / f"frame_{i:05d}.png", rng.randint(0, 5000, (H, W)).astype(np.uint16))
        if i:
            write_png(dslr / "resized_anon_masks" / f"frame_{i:05d}.png", rng.randint(0, 2, (H, W)).astype(np.uint8) * 255)


def pytorch3d_annotations(rng, seq, n, depth_dir, mask_dir=None, scale=None):
    annots = []
    for i in range(n):
        a = {"sequence_name": seq, "frame_number": i, "image": {"path": f"{seq}/images/{i:06d}.png", "size": [H, W]},
             "viewpoint": {**viewpoint(), "T": rng.randn(3).tolist()},
             "depth": {"path": f"{depth_dir}/{i:06d}.png"}}
        if scale is not None:
            a["depth"]["scale_adjustment"] = scale
        if mask_dir:
            a["mask"] = {"path": f"{mask_dir}/{i:06d}.png"}
        annots.append(a)
    return annots


def make_dynamicreplica(root):
    rng = np.random.RandomState(26)
    annots = []
    for seq in ("seq1_left", "seq1_right"):
        annots += pytorch3d_annotations(rng, seq, 2, f"{seq}/depths")
        for a in annots[-2:]:
            write_png(root / a["image"]["path"], rng_image(rng))
            write_png(root / a["depth"]["path"], rng.uniform(0.5, 9, (H, W)).astype(np.float16).view(np.uint16))
    with gzip.open(root / "frame_annotations_train.jgz", "wt") as f:
        json.dump(annots, f)


def make_co3d(root):
    rng = np.random.RandomState(27)
    cat = root / "apple"
    annots = pytorch3d_annotations(rng, "110_13051_23361", 3, "apple/110_13051_23361/depths",
                                   "apple/110_13051_23361/masks", scale=0.7)
    for a in annots:
        a["image"]["path"] = "apple/" + a["image"]["path"]
        write_png(root / a["image"]["path"], rng_image(rng))
        d = rng.uniform(0.5, 9, (H, W)).astype(np.float16)
        d[0, 0] = np.inf
        write_png(root / a["depth"]["path"], d.view(np.uint16))
        write_png(root / a["mask"]["path"], (rng.rand(H, W) > 0.5).astype(np.uint8) * 255)
    with gzip.open(cat / "frame_annotations_train.jgz", "wt") as f:
        json.dump(annots, f)


def make_mpsd(root, h=H, w=W):
    rng = np.random.RandomState(28)
    rdir = root / "reconstruction_data" / "split0" / "folderA"
    rdir.mkdir(parents=True)
    names = ["img_a.jpg", "img_b.jpg", "img_missing.jpg"]
    shots = {n: {"rotation": rng.randn(3).tolist(), "translation": rng.randn(3).tolist(), "camera": "c0"}
             for n in names[:2]}
    (rdir / "reconstruction.json").write_text(json.dumps([{"shots": shots, "cameras": {"c0": {"focal": 0.9}}}]))
    (rdir / "image_list.txt").write_text("\n".join(names) + "\n")
    for n, scale in (("img_a", 1), ("img_b", 2)):  # img_b's RGB is twice its depth's size
        write_png(root / "train" / f"{n}.jpg", rng_image(rng, h * scale, w * scale))
        write_png(root / "train" / f"{n}.png", rng.randint(50, 900, (h, w)).astype(np.uint16))


def make_sailvos3d(root):
    rng = np.random.RandomState(29)
    scene = root / "ah_3b_mcs_5"
    for i in range(2):
        n = f"{i:06d}"
        write_png(scene / "images" / f"{n}.png", rng_image(rng))
        (scene / "camera").mkdir(parents=True, exist_ok=True)
        K = [[20.0, 0, 0.3], [0, 21.0, -0.2], [0, 0, 1]]
        Rt = (np.eye(4)[:3] + 0.05 * rng.randn(3, 4)).tolist()
        (scene / "camera" / f"{n}.yaml").write_text(f"K: {json.dumps(K)}\nRt: {json.dumps(Rt)}\n")
        (scene / "depth").mkdir(exist_ok=True)
        d = rng.uniform(1e-4, 0.05, (H, W)).astype(np.float32)
        d[0, :2] = 24e-5
        np.save(scene / "depth" / f"{n}.npy", d)
        (scene / "rage_matrices").mkdir(exist_ok=True)
        np.savez(scene / "rage_matrices" / f"{n}.npz", P_inv=np.linalg.inv(np.diag([1.2, 1.5, -1.01, 1.0]) + 0.01))


def make_paralleldomain(root):
    rng = np.random.RandomState(30)
    scene = root / "scene_000100"
    (scene / "calibration").mkdir(parents=True)
    (scene / "calibration" / "c.json").write_text(json.dumps(
        {"names": ["camera_front"], "intrinsics": [{"fx": 20.0, "fy": 21.0, "cx": 8.0, "cy": 6.0}]}))
    data = []
    for i in range(2):
        rgb = f"rgb/camera_front/{i:03d}.png"
        depth = f"depth/camera_front/{i:03d}.npz"
        write_png(scene / rgb, rng_image(rng))
        (scene / depth).parent.mkdir(parents=True, exist_ok=True)
        np.savez(scene / depth, data=rng.uniform(1, 700, (H, W)).astype(np.float32))
        q = rng.randn(4)
        data.append({"datum": {"image": {"filename": rgb, "annotations": {"6": depth}, "pose": {
            "translation": dict(zip("xyz", rng.randn(3).tolist())), "rotation": dict(zip(("qx", "qy", "qz", "qw"), q.tolist()))}}}})
    data.append({"datum": {"point_cloud": {}}})
    (scene / "scene_abc.json").write_text(json.dumps({"data": data}))


def make_ase(root):
    rng = np.random.RandomState(31)
    scene = root / "0"
    (scene / "depth").mkdir(parents=True)
    (scene / "pinhole.json").write_text(json.dumps({"fx": 20.0, "fy": 20.0, "cx": 8.0, "cy": 6.0, "w": W, "h": H}))
    traj = []
    for i in range(3):
        write_png(scene / "rgb" / f"vignette{i:07d}.png", rng_image(rng))
        if i != 1:
            write_depth_exr(scene / "depth" / f"vignette{i:07d}.exr", rng.uniform(1, 5, (H, W)).astype(np.float32))
        traj.append([i * 1000] + (np.eye(4) + 0.05 * rng.randn(4, 4)).ravel().tolist())
    np.savetxt(scene / "trajectory.csv", np.asarray(traj), delimiter=",")


ADAPTER_RAW = {
    "ase": make_ase, "blendedmvs": _make_blendedmvs_raw, "co3d": make_co3d, "dl3dv": make_dl3dv,
    "dynamicreplica": make_dynamicreplica, "eth3d": make_eth3d, "mpsd": make_mpsd, "mvs_synth": make_mvs_synth,
    "paralleldomain4d": make_paralleldomain, "sailvos3d": make_sailvos3d, "scannetppv2": make_scannetpp,
    "spring": make_spring, "tav2_wb": _make_tav2_raw, "unrealstereo4k": make_unrealstereo,
}


def frame_record(fr):
    rec = dict(vars(fr))
    for key in ("image", "depth", "mask"):
        if isinstance(rec[key], Path):
            rec[key] = str(rec[key])
    if rec["size_hw"] is not None:
        rec["size_hw"] = tuple(int(v) for v in rec["size_hw"])
    return rec


def test_adapter_registry_matches_jax():
    assert sorted(port_conv.ADAPTERS) == sorted(jax_conv.ADAPTERS)
    for name, jax_adapter in jax_conv.ADAPTERS.items():
        port = port_conv.get_adapter(name)
        for attr in ("name", "camera_model", "shared_intrinsics", "scale_type", "version"):
            assert getattr(port, attr) == getattr(jax_adapter, attr), (name, attr)
    with pytest.raises(KeyError):
        port_conv.get_adapter("nope")


@pytest.mark.parametrize("name", sorted(ADAPTER_RAW))
def test_adapter_frames_match_jax(name, tmp_path):
    raw = tmp_path / "raw"
    raw.mkdir()
    ADAPTER_RAW[name](raw)
    jax_adapter, port_adapter = jax_adapters.ADAPTERS[name], port_adapters.get_adapter(name)
    scenes = port_adapter.list_scenes(raw)
    assert scenes and scenes == jax_adapter.list_scenes(raw)
    for scene in scenes:
        want = [frame_record(f) for f in jax_adapter.iter_frames(raw, scene)]
        got = [frame_record(f) for f in port_adapter.iter_frames(raw, scene)]
        assert want
        assert_same(got, want, f"{name}/{scene}")


def test_image_size_reads_headers(tmp_path):
    rng = np.random.RandomState(32)
    for suffix, shape in ((".png", (13, 17)), (".jpg", (29, 11)), (".png", (1, 1))):
        path = tmp_path / f"im_{shape[0]}{suffix}"
        write_png(path, rng_image(rng, *shape))
        assert port_adapters._image_size(path) == jax_adapters._image_size(path) == shape
    bmp = tmp_path / "im.bmp"
    write_png(bmp, rng_image(rng, 5, 9))
    assert port_adapters._image_size(bmp) == (5, 9)  # other formats through cv2


# ---------------------------------------------------------------- conversion, covisibility, aggregate, the tools


def run_script(script: Path, argv):
    spec = importlib.util.spec_from_file_location(f"script_{script.stem}", script)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.main(argv)


def tree_files(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def load_pixels(path):
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    assert img is not None, path
    return img


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """BlendedMVS (2 scenes of 5 frames, JPEG images and PFM depth) and MPSD (RGB
    arrays written as PNG, 48 x 64: a pixel is 3e-4 of a covisibility score)
    through both tools with covisibility and aggregation."""
    tmp = tmp_path_factory.mktemp("convert")
    raws = {"blendedmvs": tmp / "raw_bmvs", "mpsd": tmp / "raw_mpsd"}
    _make_blendedmvs_raw(raws["blendedmvs"], n_scenes=2, n_frames=5)
    raws["mpsd"].mkdir()
    make_mpsd(raws["mpsd"], 48, 64)
    out = {}
    for side, run in (("jax", lambda argv: run_script(ROOT / "scripts" / "convert_wai.py", argv)),
                      ("port", lambda argv: port_convert_wai.main(argv + ["--device", "cpu"]))):
        for dataset, raw in raws.items():
            wai, md = tmp / side / dataset / "wai", tmp / side / dataset / "md"
            assert run(["--dataset", dataset, "--raw-root", str(raw), "--out-root", str(wai), "--metadata-dir",
                        str(md), "--covisibility", "--aggregate", "--adjacency", "--copy", "--covis-threshold",
                        "0.1"]) == 0
            out[side, dataset] = (wai, md)
    return out


@pytest.mark.parametrize("dataset", ["blendedmvs", "mpsd"])
def test_convert_wai_tool_matches_script(dataset, converted, record_property):
    (jwai, jmd), (pwai, pmd) = converted["jax", dataset], converted["port", dataset]
    assert tree_files(pwai) == tree_files(jwai) and tree_files(pwai)
    assert tree_files(pmd) == tree_files(jmd) and tree_files(pmd)
    differing, worst = 0, 0.0
    for rel in tree_files(jwai):
        a, b = jwai / rel, pwai / rel
        if rel.endswith("scene_meta.json"):
            assert json.loads(b.read_text()) == json.loads(a.read_text()), rel
        elif rel.endswith((".png", ".jpg")):
            np.testing.assert_array_equal(load_pixels(b), load_pixels(a), err_msg=rel)
        elif rel.endswith(".exr"):
            np.testing.assert_array_equal(read_depth_exr(b), read_depth_exr(a), err_msg=rel)
        elif rel.endswith("pairwise_covisibility.npy"):
            ca, cb = np.load(a), np.load(b)
            assert ca.shape == cb.shape and ca.dtype == cb.dtype
            off = ~np.eye(len(ca), dtype=bool)
            np.testing.assert_allclose(cb[off], ca[off], atol=COVIS_ATOL, rtol=0)
            # A view's own border pixels reproject onto its border exactly, where float32
            # rounding alone keeps or drops them: the diagonal may move by one border row
            # and column of its valid pixels.
            h, w = read_depth_exr(next((a.parents[2] / "depth").iterdir())).shape
            np.testing.assert_allclose(np.diag(cb), np.diag(ca), atol=max(COVIS_ATOL, (h + w) / (h * w)), rtol=0)
            differing += int((ca != cb).sum())
            worst = max(worst, float(np.abs(ca - cb).max()))
        elif rel.endswith("_process_state.json"):
            assert {k: v["state"] for k, v in json.loads(b.read_text()).items()} == \
                   {k: v["state"] for k, v in json.loads(a.read_text()).items()}
    for rel in tree_files(jmd):
        if rel.endswith(".npy"):
            assert_same(np.load(pmd / rel, allow_pickle=True).tolist(), np.load(jmd / rel, allow_pickle=True).tolist())
        else:
            za, zb = np.load(jmd / rel, allow_pickle=True), np.load(pmd / rel, allow_pickle=True)
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                assert zb[k].item() == za[k].item(), (rel, k)
    record_property("covisibility_entries_differing", differing)
    record_property("covisibility_max_abs_diff", worst)


def test_list_converted_scenes_and_adjacency_match_jax(converted):
    wai, _ = converted["port", "blendedmvs"]
    assert port_aggregate.list_converted_scenes(wai) == jax_aggregate.list_converted_scenes(wai)
    assert port_aggregate.list_converted_scenes(wai, require_covisibility=True, require_depth=True) == \
        jax_aggregate.list_converted_scenes(wai, require_covisibility=True, require_depth=True)
    for scene in port_aggregate.list_converted_scenes(wai):
        for threshold in (0.1, 0.25, 0.9):
            assert port_aggregate.scene_adjacency(wai / scene, threshold) == \
                jax_aggregate.scene_adjacency(wai / scene, threshold)


def test_convert_scenes_states_match_jax(tmp_path):
    """Failure recording, skip-finished and overwrite, the JAX tests' cases."""
    raw = tmp_path / "raw"
    _make_blendedmvs_raw(raw, n_scenes=2, n_frames=2)
    scene = sorted(p for p in raw.iterdir())[0]
    (scene / "cams" / "00000001_cam.txt").write_text("garbage")
    results = {}
    for side, conv in (("jax", jax_conv), ("port", port_conv)):
        out = tmp_path / side
        first = conv.convert_scenes(conv.get_adapter("blendedmvs"), raw, out)
        again = conv.convert_scenes(conv.get_adapter("blendedmvs"), raw, out, overwrite=True)
        states = {s.name: conv.get_processing_state(s)["conversion"]["state"] for s in sorted(out.iterdir())}
        with pytest.raises(FileExistsError):
            conv.convert_scenes(conv.get_adapter("blendedmvs"), raw, out, skip_finished=False)
        results[side] = (first, again, states)
    assert results["port"] == results["jax"]
    assert "failed" in results["port"][2].values()
    assert port_wai.load_scene_meta(tmp_path / "port" / results["port"][0][0])["dataset_name"] == "blendedmvs"
