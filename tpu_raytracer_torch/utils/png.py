"""8-bit PNG decoding and encoding with zlib and numpy.

The port's stand-in for the PIL calls of the reference's glTF loader and
asset generator (`tpu_raytracer/scene/loader.py:_decode_image`,
`tpu_raytracer/models/dense_asset.py:_png_bytes`).

`decode` takes non-interlaced 8-bit images of colour types 0 (grey),
2 (RGB), 4 (grey + alpha) and 6 (RGBA) with any of the five row filters
and returns RGBA uint8 [H, W, 4], as `Image.open(...).convert("RGBA")`
does. Sub and Up run per row in numpy; Avg and Paeth depend on the
decoded byte to their left, so they run byte by byte in Python and are
slow on large images (the port's own encoder writes filter 0 only).
`encode_rgb` writes 8-bit RGB with filter 0.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # colour type -> samples per pixel


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n      # length, type, body, CRC


def _avg_row(line, prev, bpp):
    cur = bytearray(line)
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((a + prev[i]) >> 1)) & 0xFF
    return cur


def _paeth_row(line, prev, bpp):
    cur = bytearray(line)
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return cur


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> RGBA uint8 [H, W, 4]. Raises ValueError on what it
    does not take."""
    if data[:len(SIGNATURE)] != SIGNATURE:
        raise ValueError("not a PNG stream")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"PNG bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace}: only 8-bit, colour types "
                         f"0/2/4/6, non-interlaced are supported")
    bpp = _CHANNELS[ctype]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (stride + 1):
        raise ValueError("PNG image data is truncated")
    rows = raw[:h * (stride + 1)].reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        f, line = rows[y, 0], rows[y, 1:]
        if f == 0:
            cur = line
        elif f == 1:    # Sub: a running sum along the row, per channel
            cur = np.cumsum(line.reshape(w, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif f == 2:    # Up
            cur = line + prev
        elif f == 3:
            cur = np.frombuffer(_avg_row(line.tobytes(), prev.tobytes(),
                                         bpp), np.uint8)
        elif f == 4:
            cur = np.frombuffer(_paeth_row(line.tobytes(), prev.tobytes(),
                                           bpp), np.uint8)
        else:
            raise ValueError(f"PNG row {y} has filter type {f}")
        out[y] = cur
        prev = out[y]
    px = out.reshape(h, w, bpp)
    grey = px[..., :1].repeat(3, axis=2)
    opaque = np.full((h, w, 1), 255, np.uint8)
    rgb, alpha = {0: (grey, opaque), 2: (px, opaque), 4: (grey, px[..., 1:]),
                  6: (px[..., :3], px[..., 3:])}[ctype]
    return np.concatenate([rgb, alpha], axis=2)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_rgb(img: np.ndarray) -> bytes:
    """RGB uint8 [H, W, 3] -> PNG bytes (8-bit, filter 0 on every row)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"want an RGB image [H, W, 3], got {img.shape}")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * 3)], axis=1)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))
