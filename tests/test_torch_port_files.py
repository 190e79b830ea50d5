"""From files to a scene: the port's image files, crop/resize, checkpoints and demo, on the CPU.

The PNG reader against cv2 (files written by cv2's libpng and by PIL), the
crop/resize against the JAX package's (cv2) on seeded uint8 images over every
aspect-ratio bucket, ``load_images`` against the JAX one in its three modes,
the viewer's bytes against the JAX function's, the reference-checkpoint route
(a multimodal state dict in the reference's format through the JAX converter
and through ``load_reference_checkpoint``), the JAX ``config.json`` read by the
port's hub, and the demo tool on two PNGs. Inputs are made with numpy from
fixed seeds.
"""

import dataclasses
import json
import shutil
import struct
import sys
import zlib
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mapanything_tpu.data import cropping as jax_cropping
from mapanything_tpu.models import mapanything as jax_ma
from mapanything_tpu.utils import hub as jax_hub
from mapanything_tpu.utils import image as jax_image
from mapanything_tpu.utils import torch_convert
from mapanything_tpu.utils import viewer as jax_viewer
from mapanything_tpu_torch.data import cropping as port_cropping
from mapanything_tpu_torch.models import mapanything as port_ma
from mapanything_tpu_torch.models.heads import adaptors as port_adaptors
from mapanything_tpu_torch.tools import demo_images_only_inference as demo
from mapanything_tpu_torch.tools import load_model as port_load_model
from mapanything_tpu_torch.utils import checkpoint as port_checkpoint
from mapanything_tpu_torch.utils import colmap as port_colmap
from mapanything_tpu_torch.utils import hub as port_hub
from mapanything_tpu_torch.utils import image as port_image
from mapanything_tpu_torch.utils import threads
from mapanything_tpu_torch.utils import viewer as port_viewer
from mapanything_tpu_torch.utils.jax_params import load_jax_params
from test_torch_port_infer import seeded_params


lean_module = pytest.fixture(scope="module", autouse=True)(threads.lean_module)

# cv2 resizes uint8 with fixed-point coefficients, the port in fp32 with one rounding:
# one grey level apart at most (the worst case measured over these tests is 1).
GREY_LEVELS = 1


def smooth_image(rng, h, w, channels=3):
    """A seeded uint8 image with structure (gradients, edges) and noise."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 128 + 60 * np.sin(x / (7 + 10 * rng.random()))[..., None] + 50 * np.cos(y / (5 + 9 * rng.random()))[..., None]
    base = base + (x > w / 3)[..., None] * 40 - (y > h / 2)[..., None] * 30
    return np.clip(base + rng.normal(0, 14, (h, w, channels)), 0, 255).astype(np.uint8)


def cv2_rgb(path):
    return cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


# ---------------------------------------------------------------- PNG


def _write_cv2(path, rng, kind):
    h, w = 37, 53
    rgb8 = smooth_image(rng, h, w)
    rgb16 = rgb8.astype(np.uint16) * 257 + rng.integers(0, 256, (h, w, 3)).astype(np.uint16)
    image = {
        "rgb8": rgb8[..., ::-1], "rgb16": rgb16[..., ::-1], "grey8": rgb8[..., 0], "grey16": rgb16[..., 0],
        "rgba8": np.concatenate([rgb8, rng.integers(0, 256, (h, w, 1), dtype=np.uint8)], -1),
        "rgba16": np.concatenate([rgb16, rgb16[..., :1]], -1),
    }[kind]
    assert cv2.imwrite(str(path), np.ascontiguousarray(image))


def _write_pil(path, rng, kind):
    img = Image.fromarray(smooth_image(rng, 41, 47))
    mode, colours = {"palette8": ("P", 200), "palette4": ("P", 12), "palette2": ("P", 4), "palette1": ("P", 2),
                     "grey_alpha": ("LA", None), "bilevel": ("1", None)}[kind]
    img = img.convert("P", palette=Image.ADAPTIVE, colors=colours) if mode == "P" else img.convert(mode)
    img.save(path)


def _png_header(path):
    data = Path(path).read_bytes()
    return struct.unpack(">IIBBBBB", data[16:29])


PNG_CASES = [("cv2", k) for k in ("rgb8", "rgb16", "grey8", "grey16", "rgba8", "rgba16")] + [
    ("pil", k) for k in ("palette8", "palette4", "palette2", "palette1", "grey_alpha", "bilevel")
] + [("port", f) for f in ((0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4))]


@pytest.mark.parametrize("writer,kind", PNG_CASES)
def test_png_reader_matches_cv2(writer, kind, tmp_path):
    """Bitwise what cv2.imread(IMREAD_COLOR) + BGR2RGB gives: libpng's adaptive
    filters (cv2), palettes of 1-8 bits and grey + alpha (PIL), each scanline
    filter alone and mixed (the port's writer)."""
    rng = np.random.default_rng(PNG_CASES.index((writer, kind)))
    path = tmp_path / "image.png"
    if writer == "cv2":
        _write_cv2(path, rng, kind)
    elif writer == "pil":
        _write_pil(path, rng, kind)
    else:
        port_image.write_png(path, smooth_image(rng, 29, 31), filters=kind)
    got, ref = port_image.read_png(path), cv2_rgb(path)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    assert np.array_equal(got, ref), (writer, kind, _png_header(path))


def test_png_reader_refuses_interlaced_and_corrupt_files(tmp_path):
    path = port_image.write_png(tmp_path / "a.png", np.zeros((4, 5, 3), np.uint8))
    data = bytearray(path.read_bytes())
    data[28] = 1  # IHDR's interlace byte, with a fresh CRC
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    (tmp_path / "interlaced.png").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="interlaced"):
        port_image.read_png(tmp_path / "interlaced.png")
    data[20] ^= 1  # the width, now under a stale CRC
    (tmp_path / "corrupt.png").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        port_image.read_png(tmp_path / "corrupt.png")


def test_other_formats_decode_through_cv2_or_name_the_format(tmp_path, monkeypatch):
    """A JPEG goes through the port's own decoder, with or without cv2, and gives what
    the JAX package reads with cv2; the formats left (BMP here) go through cv2 when it
    is installed, and without it the error names the format and the way around it."""
    img = smooth_image(np.random.default_rng(5), 40, 60)
    assert cv2.imwrite(str(tmp_path / "a.jpg"), img[..., ::-1])
    assert cv2.imwrite(str(tmp_path / "a.bmp"), img[..., ::-1])
    assert np.array_equal(port_image._read_image(tmp_path / "a.jpg"), jax_image._read_image(tmp_path / "a.jpg"))
    assert np.array_equal(port_image._read_image(tmp_path / "a.bmp"), jax_image._read_image(tmp_path / "a.bmp"))
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 now raises ImportError
    loaded = port_image.load_images([tmp_path / "a.jpg"], device="cpu")
    assert loaded["images"].shape[0] == 1 and loaded["true_shape"].tolist() == [[40, 60]]
    with pytest.raises(ImportError, match="BMP.*cv2.*PNG"):
        port_image.load_images([tmp_path / "a.bmp"], device="cpu")
    with pytest.raises(ImportError, match="Bayer"):
        port_image.load_images([tmp_path / "a.jpg"], bayer_format=True, device="cpu")
    port_image.write_png(tmp_path / "b.png", img)  # PNG needs no cv2
    assert np.array_equal(port_image.read_png(tmp_path / "b.png"), img)


# ---------------------------------------------------------------- crop / resize


BUCKETS = [(res, ar) for res in (518, 512) for ar in port_image.RESOLUTION_MAPPINGS[res]]


@pytest.mark.parametrize("direction", ["down", "up"])
@pytest.mark.parametrize("res,ar", BUCKETS)
def test_crop_resize_matches_jax(res, ar, direction, record_property):
    """Every aspect-ratio bucket of both sets, down (Lanczos4) and up (cubic), with
    depth, nearest extras, a principal-point-centred pre-crop and aug_crop drawn
    from the same seeded np.random.Generator on both sides."""
    assert port_image.RESOLUTION_MAPPINGS[res][ar] == jax_image.RESOLUTION_MAPPINGS[res][ar]
    tw, th = port_image.RESOLUTION_MAPPINGS[res][ar]
    seed = BUCKETS.index((res, ar)) * 2 + (direction == "up")
    rng = np.random.default_rng(seed)
    f = rng.uniform(1.2, 1.9) if direction == "down" else rng.uniform(0.45, 0.9)
    w, h = int(tw * f * rng.uniform(0.9, 1.1)) + 1, int(th * f * rng.uniform(0.9, 1.1)) + 1
    img = smooth_image(rng, h, w)
    depth = rng.uniform(0.5, 20.0, (h, w)).astype(np.float32)
    K = np.array([[rng.uniform(200, 900), 0, w / 2 + rng.uniform(-6, 6)],
                  [0, rng.uniform(200, 900), h / 2 + rng.uniform(-6, 6)], [0, 0, 1]])
    extras = {"valid": rng.random((h, w)) > 0.3, "label": rng.integers(0, 50000, (h, w)).astype(np.int32),
              "conf": rng.random((h, w)).astype(np.float32)}
    kw = dict(principal_point_centered=seed % 3 == 0, aug_crop=24 if seed % 2 else 0)
    ref = jax_cropping.crop_resize_if_necessary(img, (tw, th), depth, K, extras, rng=np.random.default_rng(seed), **kw)
    got = port_cropping.crop_resize_if_necessary(
        torch.from_numpy(img), (tw, th), torch.from_numpy(depth), K, {k: torch.from_numpy(v) for k, v in extras.items()},
        rng=np.random.default_rng(seed), **kw)
    assert tuple(got[0].shape) == ref[0].shape == (th, tw, 3) and got[0].dtype == torch.uint8
    worst = int(np.abs(got[0].numpy().astype(int) - ref[0].astype(int)).max())
    record_property("grey_levels", worst)
    assert worst <= GREY_LEVELS
    assert np.array_equal(got[1].numpy(), ref[1])
    np.testing.assert_allclose(got[2], ref[2], atol=1e-6, rtol=0)
    for k, v in ref[3].items():
        assert got[3][k].dtype == torch.from_numpy(v).dtype and np.array_equal(got[3][k].numpy(), v), k


@pytest.mark.parametrize("interpolation,flag", [("lanczos4", cv2.INTER_LANCZOS4), ("cubic", cv2.INTER_CUBIC)])
def test_resize_of_float_images_matches_cv2(interpolation, flag):
    """On float32 images cv2 keeps float coefficients: the same taps, to fp32 rounding."""
    rng = np.random.default_rng(7)
    img = rng.random((45, 61, 3)).astype(np.float32)
    for size in ((23, 17), (61, 45), (130, 100), (7, 90)):
        ref = cv2.resize(img, size, interpolation=flag)
        got = port_cropping.resize(torch.from_numpy(img), size, interpolation).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


# ---------------------------------------------------------------- load_images


@pytest.fixture(scope="module")
def png_folder(tmp_path_factory):
    """Three PNGs written by cv2, of three sizes; the first sets the bucket."""
    folder = tmp_path_factory.mktemp("pngs")
    rng = np.random.default_rng(3)
    for name, (h, w) in (("a.png", (480, 640)), ("b.png", (500, 300)), ("c.png", (600, 1024))):
        assert cv2.imwrite(str(folder / name), smooth_image(rng, h, w)[..., ::-1])
    return folder


@pytest.mark.parametrize("mode,size", [("fixed_mapping", None), ("longest_side", 224), ("square", 224)])
def test_load_images_matches_jax(png_folder, mode, size):
    ref = jax_image.load_images(str(png_folder), resize_mode=mode, size=size)
    got = port_image.load_images(str(png_folder), resize_mode=mode, size=size, device="cpu")
    assert got["paths"] == ref["paths"] and got["data_norm_type"] == ref["data_norm_type"]
    assert got["true_shape"].dtype == torch.int32 and np.array_equal(got["true_shape"].numpy(), ref["true_shape"])
    assert got["images"].shape == ref["images"].shape
    np.testing.assert_allclose(got["images_no_norm"].numpy(), ref["images_no_norm"], atol=GREY_LEVELS / 255 + 1e-6,
                               rtol=0)
    np.testing.assert_allclose(got["images"].numpy(), ref["images"], atol=(GREY_LEVELS / 255 + 1e-6) / 0.224, rtol=0)
    # every view took the first view's bucket
    assert got["images"].shape[1:3] == ref["images"].shape[1:3]
    one = port_image.load_images([str(png_folder / "b.png")], resize_mode=mode, size=size, device="cpu")
    assert one["images"].shape[1:3] != got["images"].shape[1:3] or mode == "square"


def test_load_images_takes_arrays_and_a_stride(png_folder):
    arrays = [cv2_rgb(p) for p in sorted(png_folder.iterdir())]
    from_files = port_image.load_images(str(png_folder), stride=2, device="cpu")
    from_arrays = port_image.load_images(arrays, stride=2, device="cpu")
    assert from_arrays["paths"] == ["array_0", "array_1"] and len(from_files["paths"]) == 2
    assert torch.equal(from_arrays["images"], from_files["images"])
    with pytest.raises(ValueError, match="uint8"):
        port_image.load_images([arrays[0].astype(np.float32)], device="cpu")


def test_rgb_denormalises_like_jax():
    x = np.random.default_rng(0).normal(size=(2, 5, 6, 3)).astype(np.float32)
    np.testing.assert_allclose(port_image.rgb(torch.from_numpy(x), true_shape=(4, 5)).numpy(),
                               jax_image.rgb(x, true_shape=(4, 5)), atol=1e-6)
    u8 = np.arange(90, dtype=np.uint8).reshape(1, 5, 6, 3)
    assert torch.equal(port_image.rgb(u8), torch.from_numpy(jax_image.rgb(u8)))


# ---------------------------------------------------------------- viewer


@pytest.mark.parametrize("case", ["float_colours_cameras_mask", "uint8_colours_no_cameras"])
def test_viewer_html_bytes_equal_jax(case, tmp_path):
    rng = np.random.default_rng(11)
    pts = rng.normal(size=(2, 9, 11, 3)).astype(np.float32)
    pts[0, 0, 0] = np.nan
    kw = {}
    if case == "float_colours_cameras_mask":
        colors = rng.random((2, 9, 11, 3)).astype(np.float32)
        poses = np.tile(np.eye(4), (2, 1, 1))
        poses[:, :3, 3] = rng.normal(size=(2, 3))
        K = np.array([[[20.0, 0, 5.5], [0, 21.0, 4.5], [0, 0, 1]]] * 2)
        kw = dict(camera_poses=poses, intrinsics=K, mask=rng.random((2, 9, 11)) > 0.2, title="two views")
    else:
        colors = rng.integers(0, 256, (2, 9, 11, 3), dtype=np.uint8)
        kw = dict(max_points=50)
    jax_viewer.export_viewer_html(tmp_path / "jax.html", pts, colors, **kw)
    port_viewer.export_viewer_html(tmp_path / "port.html", pts, colors, **kw)
    assert (tmp_path / "port.html").read_bytes() == (tmp_path / "jax.html").read_bytes()


# ---------------------------------------------------------------- reference checkpoints


STEP_CFG = dict(encoder_size="test", info_sharing_depth=2, info_sharing_dim=64, info_sharing_indices=(0, 1))


@pytest.fixture(scope="module")
def multimodal():
    """A seeded JAX tree of the small multimodal model (the six geometric encoders
    included), and the port model holding it through ``load_jax_params``."""
    f32 = lambda *shape: jax.ShapeDtypeStruct(shape, jnp.float32)  # noqa: E731
    views = jax_ma.Views(img=f32(1, 2, 28, 28, 3), ray_directions=f32(1, 2, 28, 28, 3),
                         depth_along_ray=f32(1, 2, 28, 28, 1), camera_pose_quats=f32(1, 2, 4),
                         camera_pose_trans=f32(1, 2, 3), is_metric_scale=jax.ShapeDtypeStruct((1, 2), jnp.bool_))
    shapes = jax.eval_shape(jax_ma.MapAnything(jax_ma.MapAnythingConfig.small(**STEP_CFG)).init,
                            jax.random.PRNGKey(0), views)["params"]
    params = seeded_params(shapes, 4)
    port = port_ma.MapAnything(port_ma.MapAnythingConfig.small(**STEP_CFG), device="cpu", geometric_inputs=True)
    load_jax_params(port, params)
    return params, port


def reference_format(state):
    """A state dict as the reference's DDP training writes it: ``module.`` before
    every key, the DPT heads under their ``dense_head.0/.1`` names."""
    out = {}
    for k, v in state.items():
        for name, alias in (("dpt_feature_head.", "dense_head.0."), ("dpt_regressor_head.", "dense_head.1.")):
            if k.startswith(name):
                k = alias + k[len(name):]
        out["module." + k] = v.clone()
    return out


def test_reference_checkpoint_round_trips_through_the_jax_converter(multimodal, tmp_path):
    """The port's multimodal state dict, saved in the reference's format, is read back
    by the JAX package's converter as the original tree, leaf for leaf, the six
    geometric encoders included; and by ``load_reference_checkpoint`` as the same
    state dict, bitwise."""
    params, port = multimodal
    path = tmp_path / "checkpoint.pth"
    torch.save({"model": reference_format(port.state_dict()), "epoch": 3}, path)
    tree = torch_convert.convert_mapanything(torch_convert.load_torch_state_dict(str(path)))
    flat_ref = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(params)}
    flat_got = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(tree)}
    assert sorted(flat_got) == sorted(flat_ref)
    for enc in port_checkpoint.GEOMETRIC_ENCODERS:
        assert any(k.startswith(f"['{enc}']") for k in flat_got), enc
    for key, ref in flat_ref.items():
        assert flat_got[key].shape == ref.shape and np.array_equal(flat_got[key], ref), key

    state = port_checkpoint.load_reference_state_dict(path)
    assert port_checkpoint.has_geometric_encoders(port_checkpoint.canonical_keys(state))
    fresh = port_ma.MapAnything(port_ma.MapAnythingConfig.small(**STEP_CFG), device="cpu", seed=9,
                                geometric_inputs=True)
    port_checkpoint.load_reference_checkpoint(fresh, path)
    path.unlink()  # 0.25 GB, read: no test run leaves it behind
    want = port.state_dict()
    got = fresh.state_dict()
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_reference_state_dict_unpickles_in_full_only_when_trusted(tmp_path):
    """A state dict, bare or under "model", loads with ``weights_only=True``; a file
    that holds a pickled module loads only with ``trusted=True``, as its state dict."""
    import pickle

    linear = torch.nn.Linear(3, 2)
    torch.save({"model": linear.state_dict(), "epoch": 1}, tmp_path / "plain.pth")
    got = port_checkpoint.load_reference_state_dict(tmp_path / "plain.pth")
    assert sorted(got) == ["bias", "weight"] and torch.equal(got["weight"], linear.weight.detach())
    torch.save({"model": linear}, tmp_path / "module.pth")
    with pytest.raises(pickle.UnpicklingError, match="trusted=True"):
        port_checkpoint.load_reference_state_dict(tmp_path / "module.pth")
    with pytest.raises(pickle.UnpicklingError, match="trusted"):
        port_checkpoint.load_reference_checkpoint(torch.nn.Linear(3, 2), tmp_path / "module.pth")
    got = port_checkpoint.load_reference_state_dict(tmp_path / "module.pth", trusted=True)
    assert sorted(got) == ["bias", "weight"] and torch.equal(got["bias"], linear.bias.detach())
    loaded = port_checkpoint.load_reference_checkpoint(torch.nn.Linear(3, 2), tmp_path / "module.pth", trusted=True)
    assert torch.equal(loaded.weight, linear.weight)


def test_reference_checkpoint_load_is_strict(multimodal):
    _, port = multimodal
    state = reference_format(port.state_dict())
    model = lambda: port_ma.MapAnything(port_ma.MapAnythingConfig.small(**STEP_CFG), device="cpu",  # noqa: E731
                                        geometric_inputs=True)
    missing = {k: v for k, v in state.items() if not k.startswith("module.scale_token")}
    with pytest.raises(KeyError, match=r"missing \['scale_token'\]"):
        port_checkpoint.load_reference_checkpoint(model(), missing)
    with pytest.raises(KeyError, match=r"not used \['extra.weight'\]"):
        port_checkpoint.load_reference_checkpoint(model(), {**state, "module.extra.weight": torch.zeros(2)})
    wrong = dict(state, **{"module.scale_token": torch.zeros(3)})
    with pytest.raises(ValueError, match="scale_token"):
        port_checkpoint.load_reference_checkpoint(model(), wrong)
    images_only = port_ma.MapAnything(port_ma.MapAnythingConfig.small(**STEP_CFG), device="cpu")
    with pytest.raises(KeyError, match="ray_dirs_encoder"):  # the six encoders have no home there
        port_checkpoint.load_reference_checkpoint(images_only, state)
    half = {k: v.half() for k, v in state.items()}  # dtypes are cast to the model's
    loaded = port_checkpoint.load_reference_checkpoint(model(), half)
    assert all(p.dtype == torch.float32 for p in loaded.parameters())


# ---------------------------------------------------------------- hub


def test_jax_config_json_builds_the_same_config(tmp_path):
    """A config.json that the JAX save_pretrained writes builds, in the port, the
    config made from the same arguments, its remat fields included, and the port's
    save_pretrained writes them back; execution-only JAX fields are ignored, and an
    unported value raises."""
    kw = dict(compute_dtype="bfloat16", head_chunk_size=2, info_sharing_depth=2, use_scalable_softmax=True,
              remat=True, trunk_remat=False, encoder_remat_policy="save_attn_mlp_pre", trunk_remat_policy="dots")
    dense = dict(components=("ray_directions", "depth"), with_confidence=True, with_mask=True)
    jcfg = jax_ma.MapAnythingConfig.small(
        **kw, scan_layers=True,
        dense_adaptor=dataclasses.replace(jax_ma.MapAnythingConfig().dense_adaptor, **dense,
                                          confidence=type(jax_ma.MapAnythingConfig().dense_adaptor.confidence)(
                                              "sigmoid", 0.5, 4.0)))
    jax_hub.save_pretrained(jax_ma.MapAnything(jcfg), {"x": np.zeros(2, np.float32)}, tmp_path / "jax")
    got = port_hub.read_config(tmp_path / "jax")
    want = port_ma.MapAnythingConfig.small(**kw, dense_adaptor=port_adaptors.DenseAdaptorConfig(
        **dense, confidence=port_adaptors.ConfidenceConfig("sigmoid", 0.5, 4.0)))
    assert got == want
    port_model = port_ma.MapAnything(got, device="cpu")
    assert {b.remat.name for b in port_model.encoder.model.blocks} == {"save_attn_mlp_pre"}
    assert {b.remat for b in port_model.info_sharing.self_attention_blocks} == {None}
    port_hub.save_pretrained(port_model, tmp_path / "port")
    assert port_hub.read_config(tmp_path / "port") == want
    raw = json.loads((tmp_path / "jax" / "config.json").read_text())["config"]
    assert raw["dense_adaptor"]["depth"]["vmax"] == float("inf")
    with pytest.raises(NotImplementedError, match="with_mask"):
        port_hub.config_from_dict(dict(raw, with_mask=False))
    # The global-pointmap switch of pointmap+raydirs+depth+pose is ported: a config field.
    factored = dict(raw, use_factored_predictions_for_global_pointmaps=False)
    assert port_hub.config_from_dict(factored) == dataclasses.replace(
        want, use_factored_predictions_for_global_pointmaps=False)
    # The raw-encoder preset is ported with the RGB models' heads: it reads as a config field.
    rgb = dict(raw, dense_head_type="mae", use_raw_encoder_features_for_dpt=True)
    assert port_hub.config_from_dict(rgb) == dataclasses.replace(want, dense_head_type="mae",
                                                                 use_raw_encoder_features_for_dpt=True)
    with pytest.raises(ValueError, match="unknown"):
        port_hub.config_from_dict(dict(raw, not_a_field=1))


def test_hub_round_trip_and_load_model_tool(multimodal, tmp_path, capsys):
    """save_pretrained -> from_pretrained gives the same weights bitwise; its
    config.json reads as the JAX schema (the port's fields are JAX fields); the
    load_model tool counts the images-only flagship on the meta device."""
    _, port = multimodal
    port_hub.save_pretrained(port, tmp_path / "hub")
    raw = json.loads((tmp_path / "hub" / "config.json").read_text())
    assert raw["model_type"] == "mapanything"
    assert set(raw["config"]) <= {f.name for f in dataclasses.fields(jax_ma.MapAnythingConfig)}
    back = port_hub.from_pretrained(tmp_path / "hub", device="cpu")
    assert back.config == port.config and back.geometric_inputs
    want = port.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in back.state_dict().items())
    model, source = port_load_model.load_model(str(tmp_path / "hub"), device="cpu", compute_dtype="bfloat16")
    assert source == "hub" and model.config.compute_dtype == "bfloat16"
    shutil.rmtree(tmp_path / "hub")  # 0.25 GB, read
    port_load_model.main([])
    assert "500.05M parameters" in capsys.readouterr().out


# ---------------------------------------------------------------- the demo


@pytest.mark.parametrize("weights", ["random", "checkpoint"])
def test_demo_writes_the_four_outputs(tmp_path, weights):
    """The demo tool on the CPU with the small config, from two PNGs (seeded
    random weights, or a reference-format checkpoint file of the small model),
    to scene.glb, scene.ply, sparse/ and viewer.html that parse."""
    rng = np.random.default_rng(2)
    (tmp_path / "images").mkdir()
    for i in range(2):
        port_image.write_png(tmp_path / "images" / f"view_{i}.png", smooth_image(rng, 96, 128))
    args = ["--images", str(tmp_path / "images"), "--out", str(tmp_path / "out"), "--small", "--device", "cpu"]
    if weights == "checkpoint":
        saved = port_ma.MapAnything(port_ma.MapAnythingConfig.small(), device="cpu", seed=5)
        torch.save({"model": reference_format(saved.state_dict())}, tmp_path / "small.pth")
        args += ["--checkpoint", str(tmp_path / "small.pth")]
    result = demo.run(demo.parse_args(args))
    assert result["source"] == weights
    assert result["model"].config.compute_dtype == "bfloat16"
    if weights == "checkpoint":
        (tmp_path / "small.pth").unlink()  # read
        want = saved.state_dict()
        assert all(torch.equal(v, want[k]) for k, v in result["model"].state_dict().items())
    out = tmp_path / "out"
    assert sorted(p.name for p in out.iterdir()) == sorted(demo.OUTPUTS)
    assert (out / "scene.glb").read_bytes()[:4] == b"glTF"
    ply = (out / "scene.ply").read_bytes()
    n_vertices = int(ply.split(b"element vertex ")[1].split(b"\n")[0])
    body = len(ply) - ply.index(b"end_header\n") - len(b"end_header\n")
    assert n_vertices > 0 and body == n_vertices * 15  # xyz float32 + rgb uint8
    cameras, images, points = port_colmap.read_model(out / "sparse", ".bin")
    assert len(cameras) == 2 and len(images) == 2 and len(points) > 0
    assert sorted(im.name for im in images.values()) == ["view_0.png", "view_1.png"]
    assert b"2-view reconstruction" in (out / "viewer.html").read_bytes()
