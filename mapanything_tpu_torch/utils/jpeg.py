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
