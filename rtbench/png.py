"""The harness's own reader of the screenshots it checks: 8-bit RGB PNG,
not interlaced, any of the five row filters (PNG spec, section 9), every
chunk's CRC checked. The program's decoder is not used.

A filtered byte reads the decoded bytes to its left, above and above
left, so the image decodes along anti-diagonals (pixel (y, x) needs
(y, x - 1), (y - 1, x) and (y - 1, x - 1), all on the two diagonals
before its own), each diagonal at once in numpy (~1.6 s at 3840x2160 on
one CPU core).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError("PNG chunk cut short")
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n or pos + 12 + n > len(data):
            raise ValueError(f"PNG chunk {kind!r} cut short")
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        pos += 12 + n


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(filt, raw, bpp: int) -> np.ndarray:
    """The rows `raw` [H, W * bpp] under their filters `filt` [H]:
    pixels along anti-diagonals, every filter's prediction taken and
    each row's chosen."""
    h, stride = raw.shape
    w = stride // bpp
    src = raw.reshape(h, w, bpp).astype(np.int16)
    # one zero row above and one zero column to the left
    out = np.zeros((h + 1, w + 1, bpp), np.int16)
    rows_filter = filt.astype(np.int16)
    for d in range(h + w - 1):
        ys = np.arange(max(0, d - w + 1), min(h, d + 1))
        xs = d - ys
        a = out[ys + 1, xs]          # left
        b = out[ys, xs + 1]          # above
        c = out[ys, xs]              # above left
        f = rows_filter[ys][:, None]
        pred = np.where(f == 1, a, np.where(f == 2, b, np.where(
            f == 3, (a + b) >> 1, np.where(f == 4, _paeth(a, b, c), 0))))
        out[ys + 1, xs + 1] = (src[ys, xs] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8).reshape(h, stride)


def read_rgb8(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W, 3]. Raises ValueError for anything but
    a whole 8-bit RGB image that is not interlaced."""
    if data[:len(SIGNATURE)] != SIGNATURE:
        raise ValueError("not a PNG stream")
    header, idat, ended = None, [], False
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            ended = True
            break
    if header is None or not ended:
        raise ValueError("PNG without IHDR or IEND")
    w, h, depth, ctype, _, _, interlace = header
    if (depth, ctype, interlace) != (8, 2, 0):
        raise ValueError(f"PNG bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace}: want 8-bit RGB, not "
                         f"interlaced")
    bpp, stride = 3, 3 * w
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"PNG image data holds {raw.size} bytes; "
                         f"{w}x{h} RGB needs {h * (stride + 1)}")
    rows = raw.reshape(h, stride + 1)
    filt, body = rows[:, 0], rows[:, 1:]
    if filt.max(initial=0) > 4:
        raise ValueError(f"PNG row filter {int(filt.max())}")
    return _unfilter(filt, body, bpp).reshape(h, w, 3)
