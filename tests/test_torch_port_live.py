"""The port's live demo server against the JAX package's, on the CPU.

``decode_image`` against cv2 on PNG and JPEG bytes (equal pixels; other
formats raise), ``make_model_infer_fn`` on ``MapAnythingConfig.small()`` in
fp32 (the JAX tree's seeded weights carried over by ``load_jax_params``)
against the JAX ``make_model_infer_fn`` at the tolerances of
``test_torch_port_infer.py`` (each field within 1e-4 of its magnitude, masks
equal on at least 99.9% of pixels, floats compared where both masks hold,
colours, the resized uploads, within one grey level: the port's resize is
cv2's to that), ``build_viewer_html``, and an HTTP round trip through
``make_server`` on a localhost ephemeral port.
"""

import base64
import json
import threading
import urllib.request

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mapanything_tpu.models import mapanything as jax_ma
from mapanything_tpu.utils import live_server as jax_live
from mapanything_tpu_torch.models import mapanything as port_ma
from mapanything_tpu_torch.tools import live_demo
from mapanything_tpu_torch.utils import live_server as port_live
from mapanything_tpu_torch.utils import threads
from mapanything_tpu_torch.utils.jax_params import load_jax_params
from test_torch_port_infer import MASK_AGREEMENT, MODEL_RTOL, seeded_params

lean_module = pytest.fixture(scope="module", autouse=True)(threads.lean_module)

RES = 56  # a test scale: the square bucket


def photo(h=60, w=80, seed=0):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 3, yy * 4, (xx + yy) * 2], -1) % 256
    return np.clip(base + rng.randint(-20, 20, (h, w, 3)), 0, 255).astype(np.uint8)


def encoded(ext, img, params=()):
    ok, buf = cv2.imencode(ext, img[..., ::-1], list(params))
    assert ok
    return buf.tobytes()


DECODE_CASES = {
    "png_rgb": lambda: encoded(".png", photo()),
    "png_grey": lambda: encoded(".png", np.repeat(photo()[..., :1], 3, -1))[:],
    "jpeg_q95": lambda: encoded(".jpg", photo(61, 79, 1)),
    "jpeg_q60_444": lambda: encoded(".jpg", photo(33, 47, 2), (cv2.IMWRITE_JPEG_QUALITY, 60,
                                                               cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                                               cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)),
}


@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_decode_image_matches_cv2(name):
    data = DECODE_CASES[name]()
    got = port_live.decode_image(data)
    want = jax_live.decode_image(data)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_decode_image_refuses_other_formats():
    with pytest.raises(ValueError, match="PNG and JPEG"):
        port_live.decode_image(encoded(".bmp", photo(8, 8)))


@pytest.fixture(scope="module")
def small():
    """The small fp32 model: seeded weights of the JAX tree in both packages."""
    cfg = jax_ma.MapAnythingConfig.small()
    views = jax_ma.Views(img=jax.ShapeDtypeStruct((1, 2, RES, RES, 3), jnp.float32))
    shapes = jax.eval_shape(jax_ma.MapAnything(cfg).init, jax.random.PRNGKey(0), views)["params"]
    params = seeded_params(shapes, 3)
    port = port_ma.MapAnything(port_ma.MapAnythingConfig.small(), device="cpu")
    load_jax_params(port, params)
    uploads = {size: [port_live.decode_image(encoded(ext, photo(*size, s))) for s, ext in enumerate((".png", ".jpg", ".png"))]
               for size in ((RES, RES), (60, 80))}
    return {"jax": jax_live.make_model_infer_fn(jax_ma.MapAnything(cfg), {"params": params}, resolution=RES),
            "port": port_live.make_model_infer_fn(port, resolution=RES), "uploads": uploads, "model": port}


def test_resized_uploads_match_jax(small, record_property):
    """60 x 80 uploads cropped and resized to the bucket: the port's cv2-exact resize
    (data/cropping.py) is within one grey level of cv2's."""
    want = small["jax"](small["uploads"][60, 80])
    got = small["port"](small["uploads"][60, 80])
    assert set(got) == set(want) and got["points"].shape == want["points"].shape
    np.testing.assert_allclose(got["colors"], want["colors"], atol=1.0 / 255 + 1e-6, rtol=0)
    record_property("colour_pixels_differing", int((got["colors"] != want["colors"]).sum()))


def test_infer_fn_matches_jax(small, record_property):
    """Uploads at the bucket's size (no resize): the same model inputs on both sides."""
    want = small["jax"](small["uploads"][RES, RES])
    got = small["port"](small["uploads"][RES, RES])
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["colors"], want["colors"])
    agree = float((got["mask"] == want["mask"]).mean())
    record_property("mask_agreement", agree)
    assert agree >= MASK_AGREEMENT
    both = got["mask"] & want["mask"]
    for key in ("points",):
        scale = max(1.0, float(np.abs(want[key]).max()))
        err = float(np.abs(got[key][both] - want[key][both]).max()) / scale
        record_property(f"{key}_err_over_magnitude", err)
        assert got[key].shape == want[key].shape and err <= MODEL_RTOL
    scale = max(1.0, float(np.abs(want["camera_poses"]).max()))
    np.testing.assert_allclose(got["camera_poses"], want["camera_poses"], atol=MODEL_RTOL * scale, rtol=0)
    assert got["intrinsics"] is None and want["intrinsics"] is None


def test_viewer_html_and_http_round_trip(small):
    result = small["port"](small["uploads"][60, 80][:2])
    html = port_live.build_viewer_html(result, title="two views")
    assert html.startswith("<!DOCTYPE html>") and "two views" in html
    args = live_demo.parse_args(["--port", "0", "--host", "127.0.0.1", "--device", "cpu"])
    srv = live_demo.build_server(args, model=small["model"])
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        with urllib.request.urlopen(url + "/", timeout=30) as r:
            assert r.status == 200 and b"Reconstruct" in r.read()
        pngs = [encoded(".png", (im * 255).astype(np.uint8)) for im in small["uploads"][60, 80][:2]]
        body = json.dumps({"images": [base64.b64encode(b).decode() for b in pngs]}).encode()
        req = urllib.request.Request(url + "/infer", data=body, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            page = r.read().decode()
        assert r.status == 200 and "live reconstruction (2 views)" in page
        bad = urllib.request.Request(url + "/infer", data=json.dumps({"images": []}).encode())
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad, timeout=30)
        assert e.value.code == 500
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
