"""The port's baseline JPEG decoder against cv2 (libjpeg-turbo) on files written by cv2.

Qualities 50, 75 and 95; 4:4:4, 4:2:2 and 4:2:0 sampling; grey; restart
intervals; sizes that are not multiples of 16 (or of 8); an EXIF orientation;
images made with numpy from fixed seeds. Tolerance: one grey level (the
decoder follows libjpeg-turbo's islow IDCT, fancy upsampling and colour
tables, and reads these files exactly). Progressive files raise.
"""

import struct
from pathlib import Path

import cv2
import numpy as np
import pytest

from mapanything_tpu_torch.utils import jpeg
from mapanything_tpu_torch.utils import threads
from mapanything_tpu_torch.utils.image import load_images

lean_module = pytest.fixture(scope="module", autouse=True)(threads.lean_module)

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}


def scene(seed, h, w):
    """Smooth structure, edges and noise: every coefficient band is busy."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(xx / (7.0 + 5 * c) + c) * np.cos(yy / 11.0 - c) for c in range(3)], -1)
    base[(xx // 9 + yy // 7) % 5 == 0] = 20.0
    return np.clip(base + rng.randn(h, w, 3) * 18, 0, 255).astype(np.uint8)


def cv2_rgb(path):
    img = cv2.imread(str(path), cv2.IMREAD_COLOR)
    assert img is not None
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def assert_within_a_grey_level(got, want):
    assert got.shape == want.shape and got.dtype == np.uint8
    assert int(np.abs(got.astype(np.int16) - want).max()) <= 1


@pytest.mark.parametrize("h,w", [(48, 64), (37, 53), (101, 77)])
@pytest.mark.parametrize("sampling", ["444", "422", "420"])
@pytest.mark.parametrize("quality", [50, 75, 95])
def test_colour_jpeg_matches_cv2(tmp_path, quality, sampling, h, w):
    path = tmp_path / "a.jpg"
    cv2.imwrite(str(path), scene(quality + h, h, w)[..., ::-1],
                [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]])
    assert_within_a_grey_level(jpeg.read_jpeg(path), cv2_rgb(path))


@pytest.mark.parametrize("restart", [1, 3, 7])
@pytest.mark.parametrize("sampling", ["444", "420"])
def test_restart_intervals(tmp_path, restart, sampling):
    path = tmp_path / "r.jpg"
    cv2.imwrite(str(path), scene(restart, 61, 83)[..., ::-1],
                [cv2.IMWRITE_JPEG_QUALITY, 80, cv2.IMWRITE_JPEG_RST_INTERVAL, restart,
                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]])
    assert b"\xff\xdd" in path.read_bytes() and b"\xff\xd0" in path.read_bytes()  # DRI and RST0 present
    assert_within_a_grey_level(jpeg.read_jpeg(path), cv2_rgb(path))


@pytest.mark.parametrize("h,w,restart", [(45, 61, 0), (16, 16, 0), (33, 9, 2)])
def test_grey_jpeg_matches_cv2(tmp_path, h, w, restart):
    path = tmp_path / "g.jpg"
    cv2.imwrite(str(path), scene(h, h, w)[..., 1], [cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_RST_INTERVAL, restart])
    got = jpeg.read_jpeg(path)
    assert_within_a_grey_level(got, cv2_rgb(path))
    assert np.array_equal(got[..., 0], got[..., 2])  # grey repeated to three channels


def exif_app1(orientation: int) -> bytes:
    """An APP1 Exif segment with IFD0 holding the Orientation tag (big-endian TIFF)."""
    tiff = b"MM\x00\x2a" + struct.pack(">I", 8) + struct.pack(">H", 1)
    tiff += struct.pack(">HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(">I", 0)
    body = b"Exif\0\0" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


@pytest.mark.parametrize("orientation", [3, 6, 8])
def test_exif_orientation_is_applied_as_cv2_does(tmp_path, orientation):
    path = tmp_path / "o.jpg"
    ok, data = cv2.imencode(".jpg", scene(orientation, 24, 40)[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 90])
    assert ok
    data = data.tobytes()
    path.write_bytes(data[:2] + exif_app1(orientation) + data[2:])
    want = cv2_rgb(path)
    assert want.shape[:2] == ((40, 24) if orientation in (6, 8) else (24, 40))
    assert_within_a_grey_level(jpeg.read_jpeg(path), want)


def test_a_1024_by_768_frame_and_load_images(tmp_path):
    """The size of the smoke script's frames, at cv2's defaults (q95, 4:2:0), and the
    route that load_images takes for .jpg and .jpeg."""
    img = scene(5, 768, 1024)
    cv2.imwrite(str(tmp_path / "big.jpeg"), img[..., ::-1])
    assert_within_a_grey_level(jpeg.read_jpeg(tmp_path / "big.jpeg"), cv2_rgb(tmp_path / "big.jpeg"))
    loaded = load_images([tmp_path / "big.jpeg"], device="cpu")
    assert loaded["true_shape"].tolist() == [[768, 1024]] and tuple(loaded["images"].shape) == (1, 392, 518, 3)


def test_progressive_and_broken_files_raise(tmp_path):
    path = tmp_path / "p.jpg"
    cv2.imwrite(str(path), scene(1, 32, 32)[..., ::-1], [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(NotImplementedError, match="progressive"):
        jpeg.read_jpeg(path)
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode_jpeg(b"\x89PNG....")
    cv2.imwrite(str(path), scene(2, 32, 32)[..., ::-1])
    data = path.read_bytes()
    with pytest.raises(ValueError):
        jpeg.decode_jpeg(data[: len(data) // 2])  # cut inside the entropy-coded data


def test_the_smoke_scripts_jpeg_fixtures_decode_as_cv2_does():
    """tests/data/jpeg: the 1024 x 768 frames (cv2, quality 90, 4:2:0) that chip_smoke.py's
    phase 21 copies into its JPEG scene, where there is no cv2."""
    files = sorted((Path(__file__).parent / "data" / "jpeg").glob("*.jpg"))
    assert len(files) == 4 and sum(f.stat().st_size for f in files) < 1_000_000
    for f in files:
        got = jpeg.read_jpeg(f)
        assert got.shape == (768, 1024, 3)
        assert_within_a_grey_level(got, cv2_rgb(f))
