"""A baseline JPEG decoder in numpy and Python, as libjpeg-turbo decodes.

``read_jpeg(path)`` gives what ``cv2.imread(path, IMREAD_COLOR)`` then BGR ->
RGB gives: uint8 (H, W, 3) RGB, grey images repeated to three channels, the
EXIF orientation applied. It follows libjpeg-turbo's default path, the one cv2
takes:

- Huffman entropy decoding, sequential (baseline and extended 8-bit) frames,
  interleaved and single-component scans, restart intervals;
- the integer "islow" inverse DCT (jidctint.c: 13-bit constants, two passes,
  the post-IDCT range limit with its wrap-around), vectorised over all blocks;
- "fancy" chroma upsampling (jdsample.c): the triangle filter of h2v1
  (4:2:2), h1v2 and h2v2 (4:2:0, 3/4 and 1/4 weights on both axes, libjpeg's
  rounding biases), edges repeated at the component's true size; other
  integral ratios repeat samples, as libjpeg's generic upsampler;
- YCbCr -> RGB with jdcolor.c's 16-bit fixed-point tables (an Adobe marker
  with transform 0 means RGB as stored).

Progressive, lossless, arithmetic-coded, 12-bit and CMYK files raise
``NotImplementedError``. The entropy decoder is plain Python (one table lookup
a Huffman code): a 1024 x 768 4:2:0 photo takes on the order of a second.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

# Natural (row-major) position of the k-th coefficient in zig-zag order.
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
])
_ZZ = [int(z) for z in ZIGZAG]

_SOF_BASELINE = (0xC0, 0xC1)  # baseline and extended sequential, Huffman
_SOF_OTHER = {0xC2: "progressive", 0xC3: "lossless", 0xC5: "differential sequential",
              0xC6: "differential progressive", 0xC7: "differential lossless", 0xC9: "arithmetic-coded",
              0xCA: "arithmetic-coded progressive", 0xCB: "arithmetic-coded lossless",
              0xCD: "arithmetic-coded differential", 0xCE: "arithmetic-coded differential progressive",
              0xCF: "arithmetic-coded differential lossless"}


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


class _Huffman:
    """A Huffman table as a lookup on the next 16 bits of the stream: (symbol, code length)."""

    def __init__(self, counts: bytes, symbols: bytes):
        lut: List[Tuple[int, int]] = [(0, 0)] * 65536  # (0, 0): no code of the table starts so
        code, k = 0, 0
        for length in range(1, 17):
            for _ in range(counts[length - 1]):
                if code >= 1 << length:
                    raise ValueError("JPEG: a Huffman table with more codes than its lengths allow")
                lo = code << (16 - length)
                lut[lo:lo + (1 << (16 - length))] = [(symbols[k], length)] * (1 << (16 - length))
                code += 1
                k += 1
            code <<= 1
        self.lut = lut


class _Component:
    def __init__(self, ident: int, h: int, v: int, tq: int):
        self.id, self.h, self.v, self.tq = ident, h, v, tq
        self.idx: List[int] = []  # block index * 64 + natural position of each decoded coefficient
        self.val: List[int] = []


def _windows(segment: bytes) -> List[int]:
    """The entropy-coded bytes (stuffing removed) as 32-bit big-endian windows, one
    starting at every byte, with zero bytes past the end (libjpeg also feeds zeros)."""
    b = np.frombuffer(segment.replace(b"\xff\x00", b"\xff") + b"\0" * 8, np.uint8).astype(np.uint32)
    return ((b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]).tolist()


def _decode_blocks(data: bytes, blocks, dc_luts, ac_luts, ncomp: int) -> None:
    """Decode the blocks of one restart interval. ``blocks`` lists, in stream order,
    (component index, block number) pairs; each block's coefficients are appended to
    its component's idx/val lists (DC as the running prediction)."""
    w = _windows(data)
    limit = 8 * (len(w) - 5)
    p = 0
    pred = [0] * ncomp
    for comp, c, base in blocks:
        # DC: a size category, then that many bits of difference.
        lut = dc_luts[c]
        s, n = lut[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
        if not n:
            raise ValueError("JPEG: bad Huffman code")
        p += n
        diff = 0
        if s:
            diff = (w[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
            p += s
            if diff < (1 << (s - 1)):
                diff -= (1 << s) - 1
        pred[c] += diff
        idx, val = comp.idx, comp.val
        idx.append(base)
        val.append(pred[c])
        # AC: (run, size) symbols up to the end of block.
        lut = ac_luts[c]
        k = 1
        while k < 64:
            rs, n = lut[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
            if not n:
                raise ValueError("JPEG: bad Huffman code")
            p += n
            s = rs & 15
            if s:
                k += rs >> 4
                if k > 63:
                    raise ValueError("JPEG: coefficient index past 63")
                v = (w[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
                p += s
                if v < (1 << (s - 1)):
                    v -= (1 << s) - 1
                idx.append(base + _ZZ[k])
                val.append(v)
                k += 1
            elif rs == 0xF0:
                k += 16
            else:
                break
        if p > limit:
            raise ValueError("JPEG: entropy-coded data ends early")


# jidctint.c's constants: FIX(x) = round(x * 2**13).
_C = dict(f0298=2446, f0390=3196, f0541=4433, f0765=6270, f0899=7373, f1175=9633, f1501=12299, f1847=15137,
          f1961=16069, f2053=16819, f2562=20995, f3072=25172)


def _idct_pass(x, shift: int):
    """One 1-D pass of jidctint.c over axis -2 of ``x`` (..., 8, n), int64; results
    descaled by ``shift`` bits with rounding."""
    c = _C
    z2, z3 = x[..., 2, :], x[..., 6, :]
    z1 = (z2 + z3) * c["f0541"]
    tmp2 = z1 - z3 * c["f1847"]
    tmp3 = z1 + z2 * c["f0765"]
    tmp0 = (x[..., 0, :] + x[..., 4, :]) << 13
    tmp1 = (x[..., 0, :] - x[..., 4, :]) << 13
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[..., 7, :], x[..., 5, :], x[..., 3, :], x[..., 1, :]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * c["f1175"]
    t0, t1, t2, t3 = t0 * c["f0298"], t1 * c["f2053"], t2 * c["f3072"], t3 * c["f1501"]
    z1, z2 = z1 * -c["f0899"], z2 * -c["f2562"]
    z3, z4 = z3 * -c["f1961"] + z5, z4 * -c["f0390"] + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    out = np.stack([tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                    tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3], axis=-2)
    return (out + (1 << (shift - 1))) >> shift


def idct_islow(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """libjpeg's islow IDCT of quantised blocks (N, 64) in natural order with their
    table (64,): the samples (N, 8, 8) uint8, through the post-IDCT range limit."""
    x = (coef.astype(np.int64) * quant.astype(np.int64)).reshape(-1, 8, 8)  # (block, row v, column u)
    ws = _idct_pass(x, 13 - 2)  # columns: over v, for each u; PASS1_BITS = 2
    out = _idct_pass(np.swapaxes(ws, -1, -2), 13 + 2 + 3)  # rows: (block, y, u) -> over u
    out = np.swapaxes(out, -1, -2)  # (block, y, x)
    i = out & 1023  # libjpeg's IDCT_range_limit table, wrap-around included
    return np.where(i < 128, i + 128, np.where(i < 512, 255, np.where(i < 896, 0, i - 896))).astype(np.uint8)


def _fancy_h2(x: np.ndarray, rows_bias: bool) -> np.ndarray:
    """Horizontal doubling by the triangle filter (h2v1: ``rows_bias`` False, sums of
    samples; h2v2: True, on the vertical column sums with its 8/7 biases)."""
    left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.int32)
    if rows_bias:
        out[:, 0::2] = (3 * x + left + 8) >> 4
        out[:, 1::2] = (3 * x + right + 7) >> 4
    else:
        out[:, 0::2] = (3 * x + left + 1) >> 2
        out[:, 1::2] = (3 * x + right + 2) >> 2
    return out


def upsample(plane: np.ndarray, width: int, height: int, h: int, v: int, hmax: int, vmax: int) -> np.ndarray:
    """A component's plane, cut to its true size (``width`` x ``height`` samples), to the
    full sampling grid as libjpeg-turbo's jdsample.c does."""
    x = plane[:height, :width].astype(np.int32)
    hf, vf = hmax // h, vmax // v
    if hmax % h or vmax % v:
        raise NotImplementedError("JPEG: non-integral chroma sampling ratios")
    up = np.concatenate([x[:1], x[:-1]], axis=0)
    down = np.concatenate([x[1:], x[-1:]], axis=0)
    if (hf, vf) == (2, 1) and width > 2:
        return _fancy_h2(x, False)
    if (hf, vf) == (1, 2):
        out = np.empty((2 * height, width), np.int32)
        out[0::2] = (3 * x + up + 1) >> 2
        out[1::2] = (3 * x + down + 2) >> 2
        return out
    if (hf, vf) == (2, 2) and width > 2:
        out = np.empty((2 * height, 2 * width), np.int32)
        out[0::2] = _fancy_h2(3 * x + up, True)
        out[1::2] = _fancy_h2(3 * x + down, True)
        return out
    return np.repeat(np.repeat(x, vf, axis=0), hf, axis=1)


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert: 16-bit fixed-point tables, nearest-integer R and B
    terms, the G term with its half added before the shift, then clamped."""
    def fix(f):
        return int(f * 65536 + 0.5)

    xcb, xcr = cb.astype(np.int64) - 128, cr.astype(np.int64) - 128
    half = 1 << 15
    r = y + ((fix(1.40200) * xcr + half) >> 16)
    g = y + ((-fix(0.34414) * xcb + half - fix(0.71414) * xcr) >> 16)
    b = y + ((fix(1.77200) * xcb + half) >> 16)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def _exif_orientation(app1: bytes) -> int:
    """The Orientation tag (0x0112) of an APP1 Exif segment's IFD0, 1 when absent."""
    if not app1.startswith(b"Exif\0\0") or len(app1) < 14:
        return 1
    tiff = app1[6:]
    end = {b"II": "<", b"MM": ">"}.get(tiff[:2])
    if end is None:
        return 1
    (ifd,) = struct.unpack(end + "I", tiff[4:8])
    if ifd + 2 > len(tiff):
        return 1
    (n,) = struct.unpack(end + "H", tiff[ifd:ifd + 2])
    for i in range(n):
        entry = tiff[ifd + 2 + 12 * i:ifd + 14 + 12 * i]
        if len(entry) < 12:
            break
        tag, kind = struct.unpack(end + "HH", entry[:4])
        if tag == 0x0112 and kind == 3:
            return struct.unpack(end + "H", entry[8:10])[0]
    return 1


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """Turn an (H, W, ...) image upright for EXIF orientation 1-8, as cv2.imread does."""
    ops = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
           5: lambda a: np.swapaxes(a, 0, 1), 6: lambda a: np.swapaxes(a, 0, 1)[:, ::-1],
           7: lambda a: np.swapaxes(a, 0, 1)[::-1, ::-1], 8: lambda a: np.swapaxes(a, 0, 1)[::-1]}
    return np.ascontiguousarray(ops[orientation](img)) if orientation in ops else img


def decode_jpeg(data: bytes) -> np.ndarray:
    """A baseline JPEG stream as uint8 (H, W, 3) RGB (grey repeated), turned upright by
    its EXIF orientation."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG stream (no SOI marker)")
    pos = 2
    quant: Dict[int, np.ndarray] = {}
    dc_tables: Dict[int, _Huffman] = {}
    ac_tables: Dict[int, _Huffman] = {}
    comps: List[_Component] = []
    width = height = restart = 0
    adobe_transform, orientation, frame = None, 1, False
    while True:
        while pos < len(data) and data[pos] != 0xFF:
            pos += 1  # garbage between segments, as libjpeg skips it
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1  # fill bytes
        if pos >= len(data):
            raise ValueError("JPEG: no EOI marker")
        marker = data[pos]
        pos += 1
        if marker == 0xD9:  # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        body = data[pos + 2:pos + length]
        pos += length
        if marker in _SOF_OTHER:
            raise NotImplementedError(f"JPEG: {_SOF_OTHER[marker]} files are not supported (baseline only)")
        if marker in _SOF_BASELINE:
            precision, height, width, n = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise NotImplementedError(f"JPEG: {precision}-bit samples are not supported")
            if n not in (1, 3):
                raise NotImplementedError(f"JPEG: {n} components (CMYK?) are not supported")
            if height == 0:
                raise NotImplementedError("JPEG: a height given by a DNL marker is not supported")
            comps = [_Component(body[6 + 3 * i], body[7 + 3 * i] >> 4, body[7 + 3 * i] & 15, body[8 + 3 * i])
                     for i in range(n)]
            frame = True
        elif marker == 0xDB:  # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                if pq:
                    table = np.frombuffer(body[i + 1:i + 129], ">u2").astype(np.int32)
                    i += 129
                else:
                    table = np.frombuffer(body[i + 1:i + 65], np.uint8).astype(np.int32)
                    i += 65
                natural = np.empty(64, np.int32)
                natural[ZIGZAG] = table
                quant[tq] = natural
        elif marker == 0xC4:  # DHT
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = body[i + 1:i + 17]
                total = sum(counts)
                table = _Huffman(counts, body[i + 17:i + 17 + total])
                (ac_tables if tc else dc_tables)[th] = table
                i += 17 + total
        elif marker == 0xDD:  # DRI
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xEE and body.startswith(b"Adobe") and len(body) >= 12:
            adobe_transform = body[11]
        elif marker == 0xE1:
            orientation = _exif_orientation(body)
        elif marker == 0xDA:  # SOS, then the entropy-coded data up to the next marker
            if not frame:
                raise ValueError("JPEG: SOS before SOF")
            pos = _scan(data, pos, body, comps, width, height, restart, dc_tables, ac_tables)
    if not frame:
        raise ValueError("JPEG: no frame")

    hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
    mcux, mcuy = _ceil(width, 8 * hmax), _ceil(height, 8 * vmax)
    planes = []
    for c in comps:
        bw, bh = mcux * c.h, mcuy * c.v  # the component's block grid
        coef = np.zeros(bw * bh * 64, np.int32)
        coef[np.asarray(c.idx, np.int64)] = c.val
        if c.tq not in quant:
            raise ValueError(f"JPEG: quantisation table {c.tq} missing")
        blocks = idct_islow(coef.reshape(-1, 64), quant[c.tq]).reshape(bh, bw, 8, 8)
        plane = blocks.transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)
        cw, ch = _ceil(width * c.h, hmax), _ceil(height * c.v, vmax)
        planes.append(upsample(plane, cw, ch, c.h, c.v, hmax, vmax)[:height, :width])
    if len(comps) == 1:
        img = np.repeat(planes[0].astype(np.uint8)[..., None], 3, axis=-1)
    elif adobe_transform == 0 or (adobe_transform is None and [c.id for c in comps] == [82, 71, 66]):
        img = np.stack(planes, axis=-1).astype(np.uint8)  # stored as RGB
    else:
        img = _ycc_to_rgb(*planes)
    return apply_orientation(img, orientation)


def _scan(data: bytes, pos: int, header: bytes, comps, width, height, restart, dc_tables, ac_tables) -> int:
    """Decode one scan starting at ``pos`` (just past its header); returns the position
    of the marker that ends it."""
    ns = header[0]
    ids = {c.id: c for c in comps}
    scomps, dc_luts, ac_luts = [], [], []
    for i in range(ns):
        c = ids[header[1 + 2 * i]]
        td, ta = header[2 + 2 * i] >> 4, header[2 + 2 * i] & 15
        if td not in dc_tables or ta not in ac_tables:
            raise ValueError("JPEG: scan uses a Huffman table that was not defined")
        scomps.append(c)
        dc_luts.append(dc_tables[td].lut)
        ac_luts.append(ac_tables[ta].lut)
    ss, se = header[1 + 2 * ns], header[2 + 2 * ns]
    if ss != 0 or se != 63:
        raise NotImplementedError("JPEG: spectral selection (progressive scans) is not supported")

    hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
    mcux, mcuy = _ceil(width, 8 * hmax), _ceil(height, 8 * vmax)
    order = []  # (component, its index in the scan, block number * 64), in stream order
    if ns == 1:  # non-interleaved: the component's own blocks, raster order
        c = scomps[0]
        bw_grid = mcux * c.h
        nx, ny = _ceil(_ceil(width * c.h, hmax), 8), _ceil(_ceil(height * c.v, vmax), 8)
        for by in range(ny):
            for bx in range(nx):
                order.append((c, 0, (by * bw_grid + bx) * 64))
    else:
        for my in range(mcuy):
            for mx in range(mcux):
                for j, c in enumerate(scomps):
                    bw_grid = mcux * c.h
                    for v in range(c.v):
                        for h in range(c.h):
                            order.append((c, j, ((my * c.v + v) * bw_grid + mx * c.h + h) * 64))
    units = 1 if ns == 1 else sum(c.h * c.v for c in scomps)
    per_interval = restart * units if restart else len(order)

    # Split the entropy-coded data at restart markers, up to the first other marker.
    segments, start, i = [], pos, pos
    n = len(data)
    while True:
        i = data.find(b"\xff", i)
        if i < 0 or i + 1 >= n:
            raise ValueError("JPEG: scan data without an end marker")
        nxt = data[i + 1]
        if nxt == 0x00 or nxt == 0xFF:
            i += 1 if nxt == 0xFF else 2
            continue
        segments.append(data[start:i])
        if 0xD0 <= nxt <= 0xD7:
            start = i = i + 2
            continue
        break
    for k, seg in enumerate(segments):
        chunk = order[k * per_interval:(k + 1) * per_interval]
        if chunk:
            _decode_blocks(seg, chunk, dc_luts, ac_luts, len(scomps))
    return i


def read_jpeg(path) -> np.ndarray:
    """A JPEG file as uint8 (H, W, 3) RGB, as cv2.imread(IMREAD_COLOR) + BGR2RGB gives it."""
    return decode_jpeg(Path(path).read_bytes())


# --------------------------------------------------------------------------
# Baseline encoder, as cv2.imwrite(".jpg") writes with libjpeg-turbo
# --------------------------------------------------------------------------

# The JPEG standard's example quantization tables (Annex K.1), natural order.
_STD_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_STD_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99])

# The standard Huffman tables (Annex K.3): code counts by length 1-16, then symbols.
_STD_DC_LUMA = (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]), bytes(range(12)))
_STD_DC_CHROMA = (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]), bytes(range(12)))
_STD_AC_LUMA = (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]), bytes([
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
    0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0,
    0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
    0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
    0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
    0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5,
    0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
    0xF9, 0xFA]))
_STD_AC_CHROMA = (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]), bytes([
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
    0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0,
    0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48,
    0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
    0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
    0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3,
    0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
    0xF9, 0xFA]))


def quant_tables(quality: int = 95) -> Tuple[np.ndarray, np.ndarray]:
    """libjpeg's ``jpeg_set_quality`` (force_baseline): the standard tables
    scaled by 5000 / q below 50, else 200 - 2q percent, clamped to 1..255."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return tuple(np.clip((t * scale + 50) // 100, 1, 255) for t in (_STD_LUMA_Q, _STD_CHROMA_Q))


def _huffman_codes(spec) -> Tuple[np.ndarray, np.ndarray]:
    """A table's (code, length) for each of the 256 symbols (length 0: none)."""
    counts, symbols = spec
    code_of, len_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            code_of[symbols[k]], len_of[symbols[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def _rgb_to_ycc(rgb: np.ndarray) -> np.ndarray:
    """jccolor.c's 16-bit fixed point (Cb, Cr rounded by 0.5 - epsilon)."""
    def fix(x):
        return int(x * 65536 + 0.5)

    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half, offset = 1 << 15, 128 << 16
    y = (fix(0.299) * r + fix(0.587) * g + fix(0.114) * b + half) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + offset + half - 1) >> 16
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + offset + half - 1) >> 16
    return np.stack([y, cb, cr], -1)


def _pad_edges(plane: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """Repeat the last row and column out to (rows, cols), as libjpeg's
    expand_right_edge and expand_bottom_edge."""
    return np.pad(plane, ((0, rows - plane.shape[0]), (0, cols - plane.shape[1])), mode="edge")


def _fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """jfdctint.c's integer forward DCT of level-shifted (N, 8, 8) blocks
    (outputs scaled up by 8)."""
    c = {"0.298631336": 2446, "0.390180644": 3196, "0.541196100": 4433, "0.765366865": 6270,
         "0.899976223": 7373, "1.175875602": 9633, "1.501321110": 12299, "1.847759065": 15137,
         "1.961570560": 16069, "2.053119869": 16819, "2.562915447": 20995, "3.072711026": 25172}

    def descale(x, n):
        return (x + (1 << (n - 1))) >> n

    def one_pass(d, first: bool):
        t0, t7 = d[..., 0] + d[..., 7], d[..., 0] - d[..., 7]
        t1, t6 = d[..., 1] + d[..., 6], d[..., 1] - d[..., 6]
        t2, t5 = d[..., 2] + d[..., 5], d[..., 2] - d[..., 5]
        t3, t4 = d[..., 3] + d[..., 4], d[..., 3] - d[..., 4]
        t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
        out = np.empty_like(d)
        shift = 13 - 2 if first else 13 + 2
        if first:
            out[..., 0], out[..., 4] = (t10 + t11) << 2, (t10 - t11) << 2
        else:
            out[..., 0], out[..., 4] = descale(t10 + t11, 2), descale(t10 - t11, 2)
        z1 = (t12 + t13) * c["0.541196100"]
        out[..., 2] = descale(z1 + t13 * c["0.765366865"], shift)
        out[..., 6] = descale(z1 - t12 * c["1.847759065"], shift)
        z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
        z5 = (z3 + z4) * c["1.175875602"]
        t4, t5, t6, t7 = (t4 * c["0.298631336"], t5 * c["2.053119869"], t6 * c["3.072711026"],
                          t7 * c["1.501321110"])
        z1, z2 = z1 * -c["0.899976223"], z2 * -c["2.562915447"]
        z3, z4 = z3 * -c["1.961570560"] + z5, z4 * -c["0.390180644"] + z5
        out[..., 7] = descale(t4 + z1 + z3, shift)
        out[..., 5] = descale(t5 + z2 + z4, shift)
        out[..., 3] = descale(t6 + z2 + z3, shift)
        out[..., 1] = descale(t7 + z1 + z4, shift)
        return out

    rows = one_pass(blocks.astype(np.int64), True)
    return one_pass(rows.swapaxes(-1, -2), False).swapaxes(-1, -2)


def _quantize(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Divide by 8 q with rounding, symmetric about 0 (jcdctmgr.c)."""
    div = (q.reshape(8, 8) * 8).astype(np.int64)
    mag = (np.abs(coef) + (div >> 1)) // div
    return np.where(coef < 0, -mag, mag)


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(R, C) -> (R/8, C/8, 8, 8) blocks."""
    r, c = plane.shape
    return plane.reshape(r // 8, 8, c // 8, 8).swapaxes(1, 2)


def _bit_size(v: np.ndarray) -> np.ndarray:
    """The number of bits of |v| (the JPEG magnitude category)."""
    a = np.abs(v)
    n = np.zeros(a.shape, np.int64)
    while np.any(a):
        n += a > 0
        a = a >> 1
    return n


def _entropy_code(blocks: np.ndarray, table: np.ndarray, dc_codes, ac_codes) -> bytes:
    """Huffman-code (N, 64) zig-zag blocks in scan order; ``table[i]`` is block
    i's table (0 luma, 1 chroma); DC predictions by table's component are
    taken care of by the caller (``blocks[:, 0]`` holds the differences)."""
    n = blocks.shape[0]
    # Symbols and their extra bits, block by block: DC, then per nonzero AC the
    # zero-run-length escapes (ZRL), the (run, size) symbol, then EOB if needed.
    dc = blocks[:, 0]
    dc_size = _bit_size(dc)
    ac = blocks[:, 1:]
    nz_b, nz_k = np.nonzero(ac)  # row-major: by block, then by position
    nz_v = ac[nz_b, nz_k]
    first = np.ones(len(nz_b), bool)
    first[1:] = nz_b[1:] != nz_b[:-1]
    prev_k = np.where(first, -1, np.concatenate([[0], nz_k[:-1]]))
    run = nz_k - prev_k - 1
    zrl = run >> 4
    run &= 15
    size = _bit_size(nz_v)
    last = np.full(n, -1, np.int64)
    np.maximum.at(last, nz_b, nz_k)
    eob = last < 62

    # Order: each block's DC (1 item), its ACs (zrl escapes + 1 each), its EOB.
    ac_items = zrl + 1
    per_block = 1 + np.bincount(nz_b, weights=ac_items, minlength=n).astype(np.int64) + eob
    start = np.concatenate([[0], np.cumsum(per_block)[:-1]])
    total = int(per_block.sum())
    codes = np.zeros(total, np.int64)
    lens = np.zeros(total, np.int64)
    tab_b = table.astype(np.int64)

    # DC
    dcc, dcl = dc_codes
    extra = np.where(dc < 0, dc + (1 << dc_size) - 1, dc)
    codes[start] = (dcc[tab_b, dc_size] << dc_size) | extra
    lens[start] = dcl[tab_b, dc_size] + dc_size
    # AC: position of each nonzero's first item within its block
    acc_, acl = ac_codes
    item_before = np.cumsum(ac_items) - ac_items  # over all nonzeros
    block_first_item = np.zeros(n, np.int64)
    if len(nz_b):
        firsts = np.nonzero(first)[0]
        block_first_item[nz_b[firsts]] = item_before[firsts]
    pos = start[nz_b] + 1 + (item_before - block_first_item[nz_b])
    # ZRL escapes
    if np.any(zrl):
        zi = np.repeat(np.arange(len(nz_b)), zrl)
        zoff = np.arange(len(zi)) - np.repeat(np.cumsum(zrl) - zrl, zrl)
        zpos = pos[zi] + zoff
        codes[zpos] = acc_[tab_b[nz_b[zi]], 0xF0]
        lens[zpos] = acl[tab_b[nz_b[zi]], 0xF0]
    spos = pos + zrl
    sym = (run << 4) | size
    extra = np.where(nz_v < 0, nz_v + (1 << size) - 1, nz_v)
    codes[spos] = (acc_[tab_b[nz_b], sym] << size) | extra
    lens[spos] = acl[tab_b[nz_b], sym] + size
    # EOB
    epos = (start + per_block - 1)[eob]
    codes[epos] = acc_[tab_b[eob], 0x00]
    lens[epos] = acl[tab_b[eob], 0x00]

    # Bits, most significant first, padded with ones to a byte; 0xFF stuffed with 0x00.
    nbits = int(lens.sum())
    item = np.repeat(np.arange(total), lens)
    bitpos = np.arange(nbits) - np.repeat(np.cumsum(lens) - lens, lens)
    bits = ((codes[item] >> (lens[item] - 1 - bitpos)) & 1).astype(np.uint8)
    bits = np.concatenate([bits, np.ones((-nbits) % 8, np.uint8)])
    data = np.packbits(bits)
    ff = np.nonzero(data == 0xFF)[0]
    return np.insert(data, ff + 1, 0).tobytes()


def encode_jpeg(rgb: np.ndarray, quality: int = 95) -> bytes:
    """Baseline JPEG bytes of a uint8 (H, W, 3) RGB image as ``cv2.imwrite``
    writes them with libjpeg-turbo's defaults: JFIF 1.01, quality 95, YCbCr
    4:2:0 (h2v2 downsampling with alternating 1, 2 rounding biases, edges
    repeated), the islow forward DCT, the standard Huffman tables; the blocks
    past the image's last block row and column are libjpeg's dummy blocks
    (zero AC, the previous block's DC)."""
    rgb = np.asarray(rgb, np.uint8)
    H, W = rgb.shape[:2]
    qy, qc = quant_tables(quality)
    ycc = _rgb_to_ycc(rgb)
    mcu_rows, mcu_cols = _ceil(H, 16), _ceil(W, 16)
    yb_rows, yb_cols = _ceil(H, 8), _ceil(W, 8)

    # Luma: edges repeated to whole blocks; blocks outside the image are dummies.
    luma = _pad_edges(ycc[..., 0], yb_rows * 8, yb_cols * 8) - 128
    yq = _quantize(_fdct_islow(_blocks(luma)), qy)  # (yb_rows, yb_cols, 8, 8)
    grid = np.zeros((mcu_rows * 2, mcu_cols * 2, 8, 8), np.int64)
    grid[:yb_rows, :yb_cols] = yq
    if yb_cols % 2:  # the right dummy copies the DC on its left
        grid[:yb_rows, yb_cols, 0, 0] = grid[:yb_rows, yb_cols - 1, 0, 0]
    if yb_rows % 2:  # the bottom dummies copy the DC of the MCU's top-right block
        grid[yb_rows, :, 0, 0] = grid[yb_rows - 1].reshape(mcu_cols, 2, 8, 8)[:, 1, 0, 0].repeat(2)

    # Chroma: repeat the edges to whole MCUs (width) and to an even row count,
    # average 2 x 2 with biases 1, 2, 1, 2 along each row, repeat the last row.
    chroma = []
    for k in (1, 2):
        full = _pad_edges(ycc[..., k], H + H % 2, mcu_cols * 16)
        s = full[0::2, 0::2] + full[0::2, 1::2] + full[1::2, 0::2] + full[1::2, 1::2]
        bias = np.where(np.arange(s.shape[1]) % 2 == 0, 1, 2)
        down = (s + bias) >> 2
        down = _pad_edges(down, mcu_rows * 8, mcu_cols * 8) - 128
        chroma.append(_quantize(_fdct_islow(_blocks(down)), qc))

    # Interleave: per MCU, Y00 Y01 Y10 Y11 Cb Cr.
    ymcu = grid.reshape(mcu_rows, 2, mcu_cols, 2, 8, 8).transpose(0, 2, 1, 3, 4, 5).reshape(mcu_rows, mcu_cols, 4, 8, 8)
    mcus = np.concatenate([ymcu, chroma[0][:, :, None], chroma[1][:, :, None]], axis=2).reshape(-1, 64)
    zz = mcus[:, ZIGZAG]
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), mcu_rows * mcu_cols)
    dc = zz[:, 0].copy()
    for c in range(3):  # DC prediction per component
        sel = comp == c
        d = dc[sel]
        zz[sel, 0] = d - np.concatenate([[0], d[:-1]])
    dc_codes = tuple(np.stack(t) for t in zip(_huffman_codes(_STD_DC_LUMA), _huffman_codes(_STD_DC_CHROMA)))
    ac_codes = tuple(np.stack(t) for t in zip(_huffman_codes(_STD_AC_LUMA), _huffman_codes(_STD_AC_CHROMA)))
    scan = _entropy_code(zz, np.minimum(comp, 1), dc_codes, ac_codes)

    def segment(marker: int, body: bytes) -> bytes:
        return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body

    out = [b"\xff\xd8", segment(0xE0, b"JFIF\x00" + bytes([1, 1, 0, 0, 1, 0, 1, 0, 0]))]
    for t, q in enumerate((qy, qc)):
        out.append(segment(0xDB, bytes([t]) + bytes(int(v) for v in q[ZIGZAG])))
    out.append(segment(0xC0, struct.pack(">BHHB", 8, H, W, 3) + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for cls_id, spec in ((0x00, _STD_DC_LUMA), (0x10, _STD_AC_LUMA), (0x01, _STD_DC_CHROMA), (0x11, _STD_AC_CHROMA)):
        out.append(segment(0xC4, bytes([cls_id]) + spec[0] + spec[1]))
    out.append(segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])))
    out += [scan, b"\xff\xd9"]
    return b"".join(out)
