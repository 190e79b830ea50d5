"""Minimal OpenEXR 2.0 scanline IO for float depth maps, struct and numpy only.

A copy of ``mapanything_tpu/utils/exr.py`` (``write_depth_exr`` :52,
``read_depth_exr`` :123). WAI stores depth as single-channel float EXR; the
port reads the subset of the format the data path needs:

- uncompressed (NO_COMPRESSION) scanline files,
- one FLOAT, HALF or UINT channel (written as "Z"; any single-channel file is
  accepted on read, "Y"/"R" exports of other tools included),
- increasing-Y line order.

The writer emits files any standard EXR library reads; the reader parses the
generic attribute header, so it accepts the extra attributes other writers add.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

_MAGIC = 20000630
_VERSION = 2
# EXR pixel types
_UINT, _HALF, _FLOAT = 0, 1, 2
_PIXEL_SIZES = {_UINT: 4, _HALF: 2, _FLOAT: 4}
_PIXEL_DTYPES = {_UINT: "<u4", _HALF: "<f2", _FLOAT: "<f4"}


def _attr(name: str, type_name: str, data: bytes) -> bytes:
    return (
        name.encode() + b"\0" + type_name.encode() + b"\0"
        + struct.pack("<i", len(data)) + data
    )


def _chlist(channels: Tuple[Tuple[str, int], ...]) -> bytes:
    out = b""
    for ch_name, pixel_type in channels:
        out += ch_name.encode() + b"\0"
        out += struct.pack("<i", pixel_type)   # pixel type
        out += struct.pack("<4B", 0, 0, 0, 0)  # pLinear + reserved
        out += struct.pack("<2i", 1, 1)        # x/y sampling
    return out + b"\0"


def write_depth_exr(path, depth: np.ndarray) -> None:
    """Write (H, W) float32 data as an uncompressed single-channel EXR."""
    depth = np.ascontiguousarray(depth, dtype="<f4")
    assert depth.ndim == 2, f"expected (H, W) depth, got {depth.shape}"
    H, W = depth.shape

    box = struct.pack("<4i", 0, 0, W - 1, H - 1)
    header = b"".join(
        [
            _attr("channels", "chlist", _chlist((("Z", _FLOAT),))),
            _attr("compression", "compression", b"\0"),  # NO_COMPRESSION
            _attr("dataWindow", "box2i", box),
            _attr("displayWindow", "box2i", box),
            _attr("lineOrder", "lineOrder", b"\0"),  # INCREASING_Y
            _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
            _attr("screenWindowCenter", "v2f", struct.pack("<2f", 0.0, 0.0)),
            _attr("screenWindowWidth", "float", struct.pack("<f", 1.0)),
        ]
    ) + b"\0"

    preamble = struct.pack("<ii", _MAGIC, _VERSION)
    offset_table_pos = len(preamble) + len(header)
    first_chunk = offset_table_pos + 8 * H
    row_bytes = 4 * W
    chunk_bytes = 8 + row_bytes  # y (i32) + size (i32) + pixels

    offsets = struct.pack(
        "<%dQ" % H, *[first_chunk + i * chunk_bytes for i in range(H)]
    )

    with open(path, "wb") as f:
        f.write(preamble)
        f.write(header)
        f.write(offsets)
        for y in range(H):
            f.write(struct.pack("<2i", y, row_bytes))
            f.write(depth[y].tobytes())


def _read_header(f) -> Dict:
    attrs = {}
    while True:
        name = _read_cstr(f)
        if name == "":
            return attrs
        type_name = _read_cstr(f)
        (size,) = struct.unpack("<i", f.read(4))
        attrs[name] = (type_name, f.read(size))


def _read_cstr(f) -> str:
    out = b""
    while True:
        c = f.read(1)
        if c in (b"", b"\0"):
            return out.decode()
        out += c


def _parse_chlist(data: bytes):
    channels = []
    pos = 0
    while data[pos] != 0:
        end = data.index(b"\0", pos)
        name = data[pos:end].decode()
        pixel_type = struct.unpack_from("<i", data, end + 1)[0]
        channels.append((name, pixel_type))
        pos = end + 1 + 4 + 4 + 8  # type + plinear/reserved + samplings
    return channels


def read_depth_exr(path) -> np.ndarray:
    """Read an uncompressed single-channel scanline EXR as (H, W) float32."""
    with open(Path(path), "rb") as f:
        magic, version = struct.unpack("<ii", f.read(8))
        if magic != _MAGIC:
            raise ValueError(f"{path}: not an EXR file")
        if version & 0x200:  # multipart/deep bit flags
            raise NotImplementedError(f"{path}: multipart EXR not supported")
        attrs = _read_header(f)

        compression = attrs["compression"][1][0]
        if compression != 0:
            raise NotImplementedError(
                f"{path}: compressed EXR (type {compression}) not supported; "
                "re-export uncompressed or install an OpenEXR-enabled cv2"
            )
        channels = _parse_chlist(attrs["channels"][1])
        if len(channels) != 1:
            raise NotImplementedError(
                f"{path}: expected single-channel depth, got {channels}"
            )
        _, pixel_type = channels[0]
        xmin, ymin, xmax, ymax = struct.unpack("<4i", attrs["dataWindow"][1])
        W, H = xmax - xmin + 1, ymax - ymin + 1

        f.read(8 * H)  # offset table (chunks follow contiguously)
        px_size = _PIXEL_SIZES[pixel_type]
        out = np.empty((H, W), np.float32)
        for _ in range(H):
            y, size = struct.unpack("<2i", f.read(8))
            assert size == px_size * W, f"unexpected chunk size {size}"
            row = np.frombuffer(f.read(size), _PIXEL_DTYPES[pixel_type])
            out[y - ymin] = row.astype(np.float32)
        return out
