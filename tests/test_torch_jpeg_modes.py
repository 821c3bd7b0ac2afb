"""The JPEG modes of `utils/jpeg.py` that Pillow's own encoder cannot
write, held to Pillow 12.1.0 (libjpeg-turbo 3.1.3, the decoder of the
reference's glTF loader) on streams this file writes.

The writer below is small and plain numpy: a float DCT and quantization
at the Annex K quality-75 tables, box-averaged chroma, and entropy coders
of its own: Huffman (one code length a table), the QM arithmetic coder of
ITU T.81 Annex D with DAC conditioning, and lossless (Annex H)
prediction. Every stream is 37x23 pixels (odd in both directions, so the
blocks and MCUs are padded), with and without a restart interval.

Pillow decides what is a gap: where Pillow decodes a stream, `decode`
must return its `.convert("RGBA")` bytes exactly (tolerance: none); where
Pillow raises, the reference cannot load the file either, and the port
must raise too. Modes:
  - baseline Huffman at sampling 4:4:0 (luma 1x2) and 4:1:1 (luma 4x1);
  - YCCK (Adobe transform 2), 4:2:0 with K at full size;
  - arithmetic-coded sequential (SOF9) and progressive (SOF10), with the
    DAC marker's default conditioning and with other values;
  - lossless (SOF3), predictors 1-7, point transforms 0 and 2, grey,
    three and four components, subsampled components;
  - progressive scripts that stop before the last successive-
    approximation refinement of the DC terms and of AC 1-9, which
    libjpeg smooths (jdcoefct.c:decompress_smooth_data);
  - refused by Pillow and by the port: hierarchical (DHP) and the
    differential frames (SOF5-7, SOF13-15), arithmetic-coded lossless
    (SOF11), 12-bit, 2-component and DNL-height streams, fractional
    sampling, a lossless restart interval that is not whole rows, and
    lossless streams marked YCbCr or YCCK (libjpeg-turbo converts no
    colour in lossless mode).
"""

import struct
from io import BytesIO

import numpy as np
import pytest
from PIL import Image

from tpu_raytracer_torch.utils import jpeg

W, H = 37, 23
MAX_BYTES = 8192          # each stream stays a few KB

ZIGZAG = [
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]

# quality-75 tables of ITU T.81 Annex K, in zigzag order
QUANT = [
    [8, 6, 6, 7, 6, 5, 8, 7, 7, 7, 9, 9, 8, 10, 12, 20, 13, 12, 11, 11, 12,
     25, 18, 19, 15, 20, 29, 26, 31, 30, 29, 26, 28, 28, 32, 36, 46, 39, 32,
     34, 44, 35, 28, 28, 40, 55, 41, 44, 48, 49, 52, 52, 52, 31, 39, 57, 61,
     56, 50, 60, 46, 51, 52, 50],
    [9, 9, 9, 12, 11, 12, 24, 13, 13, 24, 50, 33, 28, 33, 50, 50, 50, 50, 50,
     50, 50, 50, 50, 50, 50, 50, 50, 50, 50, 50, 50, 50, 50, 50, 50, 50, 50,
     50, 50, 50, 50, 50, 50, 50, 50, 50, 50, 50, 50, 50, 50, 50, 50, 50, 50,
     50, 50, 50, 50, 50, 50, 50, 50, 50]]


def image(w, h, channels=3, seed=0):
    """Noise over gradients, as tests/test_torch_jpeg.py makes them."""
    g = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                     (x * 7 + y * 3) % 256, (x * y) % 256], axis=-1)
    img = np.clip(base + g.integers(-40, 41, base.shape), 0, 255)
    return img[..., :channels].astype(np.int64)


def to_ycc(rgb):
    """JFIF's RGB -> YCbCr, rounded."""
    r, g, b = (rgb[..., k].astype(np.float64) for k in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128
    return [np.clip(np.round(c), 0, 255).astype(np.int64) for c in (y, cb, cr)]


class Layout:
    """Sampling of a frame: per component (h, v); the MCU grid and each
    component's plane and block grid, as T.81 A.1.1 defines them."""

    def __init__(self, w, h, factors):
        self.w, self.h, self.factors = w, h, factors
        self.hmax = max(f[0] for f in factors)
        self.vmax = max(f[1] for f in factors)
        self.mcux = -(-w // (8 * self.hmax))
        self.mcuy = -(-h // (8 * self.vmax))

    def plane_size(self, c):
        fh, fv = self.factors[c]
        return -(-self.w * fh // self.hmax), -(-self.h * fv // self.vmax)


def downsample(plane, layout, c):
    """A full-size plane to component c's samples, box-averaged, padded by
    edge replication to the component's MCU-padded block grid."""
    fh, fv = layout.factors[c]
    sh, sv = layout.hmax // fh, layout.vmax // fv
    h, w = plane.shape
    p = np.pad(plane, ((0, (-h) % sv), (0, (-w) % sh)), mode="edge")
    p = p.reshape(p.shape[0] // sv, sv, p.shape[1] // sh, sh).mean(axis=(1, 3))
    dw, dh = layout.plane_size(c)
    p = np.round(p[:dh, :dw]).astype(np.int64)
    bw, bh = layout.mcux * fh * 8, layout.mcuy * fv * 8
    return np.pad(p, ((0, bh - dh), (0, bw - dw)), mode="edge")


_K = np.arange(8)
_DCT = np.cos((2 * _K[None, :] + 1) * _K[:, None] * np.pi / 16) * np.where(
    _K[:, None] == 0, np.sqrt(1 / 8), np.sqrt(2 / 8))


def fdct_quant(plane, quant_zz):
    """Samples [8 by, 8 bx] -> quantized coefficients [by, bx, 64] in
    natural order."""
    bh, bw = plane.shape[0] // 8, plane.shape[1] // 8
    blocks = (plane - 128.0).reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
    coef = _DCT @ blocks @ _DCT.T
    q = np.zeros(64)
    q[ZIGZAG] = quant_zz
    return np.round(coef.reshape(bh, bw, 64) / q).astype(np.int64).tolist()


def mcu_blocks(layout, comps):
    """Block order of an interleaved scan over components `comps`: per
    MCU a list of (component, by, bx); one component alone is not
    interleaved (its own ceil(dw / 8) x ceil(dh / 8) blocks)."""
    if len(comps) == 1:
        c = comps[0]
        dw, dh = layout.plane_size(c)
        return [[(c, by, bx)] for by in range(-(-dh // 8))
                for bx in range(-(-dw // 8))]
    out = []
    for my in range(layout.mcuy):
        for mx in range(layout.mcux):
            mcu = []
            for c in comps:
                fh, fv = layout.factors[c]
                mcu += [(c, my * fv + y, mx * fh + x) for y in range(fv)
                        for x in range(fh)]
            out.append(mcu)
    return out


# ---------------------------------------------------------------------------
# markers
# ---------------------------------------------------------------------------

def segment(marker, body):
    """A marker segment: the marker, its length and its body."""
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + bytes(body)


def dqt(tables):
    body = b""
    for i, t in enumerate(tables):
        body += bytes([i]) + bytes(t)
    return segment(0xDB, body)


def sof(marker, w, h, comps, precision=8):
    body = struct.pack(">BHHB", precision, h, w, len(comps))
    for cid, fh, fv, tq in comps:
        body += bytes([cid, fh << 4 | fv, tq])
    return segment(marker, body)


def sos(comps, ss, se, ah, al):
    body = bytes([len(comps)])
    for cid, td, ta in comps:
        body += bytes([cid, td << 4 | ta])
    return segment(0xDA, body + bytes([ss, se, ah << 4 | al]))


def adobe(transform):
    return segment(0xEE, b"Adobe" + b"\x00\x64\x00\x00\x00\x00"
                   + bytes([transform]))


# ---------------------------------------------------------------------------
# Huffman coding
# ---------------------------------------------------------------------------

class Huffman:
    """A canonical code giving `symbols` one length `bits` each."""

    def __init__(self, symbols, bits):
        assert len(symbols) < 1 << bits
        self.symbols = list(symbols)
        self.bits = bits
        self.code = {s: (i, bits) for i, s in enumerate(self.symbols)}

    def dht(self, tc, th):
        counts = [0] * 16
        counts[self.bits - 1] = len(self.symbols)
        return bytes([tc << 4 | th]) + bytes(counts) + bytes(self.symbols)


DC_CODE = Huffman(range(12), 4)
AC_CODE = Huffman([0x00, 0xF0] + [r << 4 | s for r in range(16)
                                  for s in range(1, 11)]
                  + [r << 4 for r in range(1, 15)], 8)
LOSSLESS_CODE = Huffman(range(17), 5)


class BitWriter:
    """Huffman-coded bits, 0xFF bytes stuffed, the last byte padded with
    1 bits."""

    def __init__(self):
        self.out = bytearray()
        self.acc = self.n = 0

    def put(self, value, n):
        for i in range(n - 1, -1, -1):
            self.acc = self.acc << 1 | (value >> i) & 1
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc = self.n = 0

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def magnitude(v):
    """(category, bits) of a signed value (T.81 F.1.2.1.1)."""
    v = int(v)
    s = abs(v).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


def huff_sequential(bw, block, pred, dc, ac):
    """One block [64, natural order] of a sequential Huffman scan (F.1.2);
    returns its DC term, the next predictor."""
    s, bits = magnitude(block[0] - pred)
    bw.put(*dc.code[s])
    bw.put(bits, s)
    run = 0
    for k in range(1, 64):
        v = block[ZIGZAG[k]]
        if v == 0:
            run += 1
            continue
        while run > 15:
            bw.put(*ac.code[0xF0])
            run -= 16
        s, bits = magnitude(v)
        bw.put(*ac.code[run << 4 | s])
        bw.put(bits, s)
        run = 0
    if run:
        bw.put(*ac.code[0x00])
    return block[0]


# ---------------------------------------------------------------------------
# arithmetic coding (ITU T.81 Annex D, as jcarith.c codes it)
# ---------------------------------------------------------------------------

class ArithEncoder:
    """The QM coder of ITU T.81 Annex D as jcarith.c writes it: interval
    registers, carry propagation over stacked 0xFF bytes, pending zeros
    dropped at the end, and jcarith.c:finish_pass's termination."""

    def __init__(self, qe_table):
        self.tab = qe_table
        self.c, self.a, self.sc, self.zc, self.ct = 0, 0x10000, 0, 0, 11
        self.buffer = -1
        self.out = bytearray()

    def _emit(self, b):
        self.out.append(b)

    def encode(self, st, i, val):
        sv = st[i]
        qe, nm, nl, sw = self.tab[sv & 0x7F]
        nl = sw << 7 | nl
        self.a -= qe
        if val != sv >> 7:
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._zeros()
                        self._emit(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self._emit(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._settle()
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def _zeros(self):
        while self.zc:
            self._emit(0)
            self.zc -= 1

    def _settle(self):
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self._zeros()
            self._emit(self.buffer)
        if self.sc:
            self._zeros()
            while self.sc:
                self._emit(0xFF)
                self._emit(0)
                self.sc -= 1

    def finish(self):
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            self._settle()
        if self.c & 0x7FFF800:
            self._zeros()
            self._emit((self.c >> 19) & 0xFF)
            if (self.c >> 19) & 0xFF == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
                if (self.c >> 11) & 0xFF == 0xFF:
                    self._emit(0)
        return bytes(self.out)


# ---------------------------------------------------------------------------
# arithmetic-coded scans (jcarith.c)
# ---------------------------------------------------------------------------

class ArithScan:
    """One restart interval of an arithmetic-coded scan: the coder, the
    statistics bins at 0, the fixed bin, DC predictors and contexts."""

    def __init__(self, qe, ncomps, cond):
        self.e = ArithEncoder(qe)
        self.dc_stats, self.ac_stats = {}, {}
        self.fixed = [113]
        self.last = [0] * ncomps
        self.ctx = [0] * ncomps
        self.cond = cond

    def finish(self):
        return self.e.finish()

    def magnitude(self, st, i, v, wide):
        """F.8 and F.9 for v - 1 = v (>= 0) from bin i; `wide` the bins of
        the larger categories (None: DC's, X1 = 20)."""
        e = self.e
        m = 0
        if v:
            e.encode(st, i, 1)
            m = 1
            v2 = v >> 1
            if wide is None:
                i = 20
                while v2:
                    e.encode(st, i, 1)
                    m <<= 1
                    i += 1
                    v2 >>= 1
            elif v2:
                e.encode(st, i, 1)
                m <<= 1
                i = wide
                v2 >>= 1
                while v2:
                    e.encode(st, i, 1)
                    m <<= 1
                    i += 1
                    v2 >>= 1
        e.encode(st, i, 0)
        return m, i

    def bits(self, st, i, m, v):
        """F.9: the bits of v below its category m, with bin i + 14."""
        m >>= 1
        while m:
            self.e.encode(st, i + 14, 1 if m & v else 0)
            m >>= 1

    def dc(self, k, tbl, value):
        """F.4: component k's DC term `value` against its predictor."""
        st = self.dc_stats.setdefault(tbl, [0] * 64)
        e, i = self.e, self.ctx[k]
        v = value - self.last[k]
        if v == 0:
            e.encode(st, i, 0)
            self.ctx[k] = 0
            return
        self.last[k] = value
        e.encode(st, i, 1)
        sign = int(v < 0)
        e.encode(st, i + 1, sign)
        self.ctx[k] = 8 if sign else 4
        m, i = self.magnitude(st, i + 2 + sign, abs(v) - 1, None)
        lo, hi, _ = self.cond[tbl]
        if m < (1 << lo) >> 1:
            self.ctx[k] = 0
        elif m > (1 << hi) >> 1:
            self.ctx[k] += 8
        self.bits(st, i, m, abs(v) - 1)

    def ac_value(self, tbl, k, i, v):
        """A nonzero value v at coefficient k, its decision bins from i."""
        st = self.ac_stats.setdefault(tbl, [0] * 256)
        self.e.encode(self.fixed, 0, int(v < 0))
        wide = 189 if k <= self.cond[tbl][2] else 217
        m, i = self.magnitude(st, i + 2, abs(v) - 1, wide)
        self.bits(st, i, m, abs(v) - 1)

    def ac_run(self, tbl, vals, ss, se):
        """F.5 over vals[k] (zigzag, point-transformed) for k in ss..se."""
        st = self.ac_stats.setdefault(tbl, [0] * 256)
        e = self.e
        ke = max([k for k in range(ss, se + 1) if vals[k]], default=0)
        k = ss
        while k <= ke:
            i = 3 * (k - 1)
            e.encode(st, i, 0)
            while vals[k] == 0:
                e.encode(st, i + 1, 0)
                i += 3
                k += 1
            e.encode(st, i + 1, 1)
            self.ac_value(tbl, k, i, vals[k])
            k += 1
        if k <= se:
            e.encode(st, 3 * (k - 1), 1)

    def ac_refine(self, tbl, coef_zz, ss, se, al):
        """G.1.3.3 (jcarith.c:encode_mcu_AC_refine)."""
        st = self.ac_stats.setdefault(tbl, [0] * 256)
        e = self.e
        at = [abs(c) >> al for c in coef_zz]
        ke = max([k for k in range(ss, se + 1) if at[k]], default=0)
        kex = max([k for k in range(1, ke + 1) if at[k] >> 1], default=0)
        k = ss
        while k <= ke:
            i = 3 * (k - 1)
            if k > kex:
                e.encode(st, i, 0)
            while True:
                v = at[k]
                if v:
                    if v >> 1:
                        e.encode(st, i + 2, v & 1)
                    else:
                        e.encode(st, i + 1, 1)
                        e.encode(self.fixed, 0, int(coef_zz[k] < 0))
                    break
                e.encode(st, i + 1, 0)
                i += 3
                k += 1
            k += 1
        if k <= se:
            e.encode(st, 3 * (k - 1), 1)


def shift_ac(c, al):
    """An AC term under point transform al: |c| >> al with c's sign."""
    return (abs(c) >> al) * (1 if c >= 0 else -1)


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------

TABLE = (0, 1, 1, 0)    # the entropy tables of Y, Cb, Cr and K


def dct_coefs(planes, factors, qsel):
    """Full-size planes -> (layout, per component its quantized
    coefficients [by, bx, 64] over the MCU-padded block grid)."""
    h, w = planes[0].shape
    layout = Layout(w, h, factors)
    return layout, [fdct_quant(downsample(p, layout, c), QUANT[qsel[c]])
                    for c, p in enumerate(planes)]


def _intervals(items, restart):
    """items cut into restart intervals of `restart` (0: one interval)."""
    per = restart or len(items)
    return [items[i:i + per] for i in range(0, len(items), per)]


def _join(parts):
    """Restart intervals' data joined with RST0-RST7 in turn."""
    out = bytearray()
    for i, data in enumerate(parts):
        if i:
            out += bytes([0xFF, 0xD0 + (i - 1) % 8])
        out += data
    return bytes(out)


def huffman_scan(layout, coefs, comps, ss, se, ah, al, restart):
    """Entropy-coded data of a Huffman scan: sequential, DC first or
    refine, or AC first (no end-of-band runs); tables 0 everywhere."""
    parts = []
    for mcus in _intervals(mcu_blocks(layout, comps), restart):
        bw, pred = BitWriter(), {}
        for mcu in mcus:
            for c, by, bx in mcu:
                block = coefs[c][by][bx]
                if ss == 0 and se == 63:
                    pred[c] = huff_sequential(bw, block, pred.get(c, 0),
                                              DC_CODE, AC_CODE)
                elif ss == 0 and ah == 0:
                    v = block[0] >> al
                    s, bits = magnitude(v - pred.get(c, 0))
                    bw.put(*DC_CODE.code[s])
                    bw.put(bits, s)
                    pred[c] = v
                elif ss == 0:
                    bw.put((block[0] >> al) & 1, 1)
                else:
                    assert ah == 0, "no Huffman AC refinement here"
                    run = 0
                    for k in range(ss, se + 1):
                        v = shift_ac(block[ZIGZAG[k]], al)
                        if v == 0:
                            run += 1
                            continue
                        while run > 15:
                            bw.put(*AC_CODE.code[0xF0])
                            run -= 16
                        s, bits = magnitude(v)
                        bw.put(*AC_CODE.code[run << 4 | s])
                        bw.put(bits, s)
                        run = 0
                    if run:
                        bw.put(*AC_CODE.code[0x00])
        parts.append(bw.flush())
    return _join(parts)


def arith_scan(layout, coefs, comps, ss, se, ah, al, restart, cond,
               progressive):
    """Entropy-coded data of an arithmetic-coded scan; conditioning
    tables 0 everywhere."""
    parts = []
    for mcus in _intervals(mcu_blocks(layout, comps), restart):
        sc = ArithScan(jpeg._QE, len(comps), cond)
        for mcu in mcus:
            for c, by, bx in mcu:
                k, t = comps.index(c), TABLE[c]
                block = coefs[c][by][bx]
                zz = [int(block[ZIGZAG[i]]) for i in range(64)]
                if not progressive:
                    sc.dc(k, t, zz[0])
                    sc.ac_run(t, zz, 1, 63)
                elif ss == 0 and ah == 0:
                    sc.dc(k, t, zz[0] >> al)
                elif ss == 0:
                    sc.e.encode(sc.fixed, 0, (zz[0] >> al) & 1)
                elif ah == 0:
                    sc.ac_run(t, [shift_ac(x, al) for x in zz], ss, se)
                else:
                    sc.ac_refine(t, zz, ss, se, al)
        parts.append(sc.finish())
    return _join(parts)


def write_dct(layout, coefs, ids, qsel, sof_marker, scans, restart=0,
              pre=b"", dac=None):
    """A DCT-based stream: scans are (component indices, ss, se, ah, al);
    Huffman-coded (SOF0-2) or arithmetic-coded (SOF9, SOF10) by the
    marker; dac: the DAC marker's (index, value) pairs."""
    arith = sof_marker in (0xC9, 0xCA)
    cond = {0: [0, 1, 5], 1: [0, 1, 5]}
    out = b"\xff\xd8" + pre + dqt([QUANT[0], QUANT[1]])
    out += sof(sof_marker, layout.w, layout.h,
               [(ids[c], *layout.factors[c], qsel[c])
                for c in range(len(ids))])
    if arith:
        for index, val in dac or ():
            if index < 16:
                cond[index][:2] = [val & 15, val >> 4]
            else:
                cond[index - 16][2] = val
        if dac:
            out += segment(0xCC, b"".join(bytes(p) for p in dac))
    else:
        out += segment(0xC4, DC_CODE.dht(0, 0) + AC_CODE.dht(1, 0)
                       + DC_CODE.dht(0, 1) + AC_CODE.dht(1, 1))
    if restart:
        out += segment(0xDD, struct.pack(">H", restart))
    for comps, ss, se, ah, al in scans:
        out += sos([(ids[c], TABLE[c], TABLE[c]) for c in comps], ss, se,
                   ah, al)
        if arith:
            out += arith_scan(layout, coefs, comps, ss, se, ah, al, restart,
                              cond, sof_marker == 0xCA)
        else:
            out += huffman_scan(layout, coefs, comps, ss, se, ah, al,
                                restart)
    return out + b"\xff\xd9"


def write_lossless(planes, psv, pt, restart_rows=0, ids=(1, 2, 3), pre=b"",
                   factors=None):
    """A lossless (SOF3) stream of full-size planes [h, w]: one
    interleaved scan with predictor psv and point transform pt, MCUs of
    h x v samples a component (`factors`, 1x1 by default; a subsampled
    plane is taken every h-th column and v-th row and padded by edge
    replication to the MCU grid), a restart every `restart_rows` MCU
    rows. Each component's rows are predicted over its whole padded
    grid: the padding is never a predictor of a real sample."""
    h, w = planes[0].shape
    n = len(planes)
    factors = factors or [(1, 1)] * n
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    mcux, mcuy = -(-w // hmax), -(-h // vmax)
    x = []
    for p, (fh, fv) in zip(planes, factors):
        sub = (p >> pt)[::vmax // fv, ::hmax // fh]
        x.append(np.pad(sub, ((0, mcuy * fv - sub.shape[0]),
                              (0, mcux * fh - sub.shape[1])), mode="edge"))
    rows = restart_rows or mcuy

    def pred(c, y, xx):
        p = x[c]
        ra = int(p[y, xx - 1]) if xx else None
        if y % (rows * factors[c][1]) == 0:          # an interval's first
            return ra if xx else 1 << (7 - pt)
        if not xx:
            return int(p[y - 1, 0])
        rb, rc = int(p[y - 1, xx]), int(p[y - 1, xx - 1])
        return (ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1),
                rb + ((ra - rc) >> 1), (ra + rb) >> 1)[psv - 1]

    parts = []
    for my0 in range(0, mcuy, rows):
        bw = BitWriter()
        for my in range(my0, min(my0 + rows, mcuy)):
            for mx in range(mcux):
                for c, (fh, fv) in enumerate(factors):
                    for y in range(my * fv, my * fv + fv):
                        for xx in range(mx * fh, mx * fh + fh):
                            d = (int(x[c][y, xx]) - pred(c, y, xx)
                                 + 32767) % 65536 - 32767
                            if d == 32768:
                                bw.put(*LOSSLESS_CODE.code[16])
                            else:
                                s, bits = magnitude(d)
                                bw.put(*LOSSLESS_CODE.code[s])
                                bw.put(bits, s)
        parts.append(bw.flush())
    out = b"\xff\xd8" + pre + sof(0xC3, w, h, [(ids[c], *factors[c], 0)
                                               for c in range(n)])
    out += segment(0xC4, LOSSLESS_CODE.dht(0, 0))
    if restart_rows:
        out += segment(0xDD, struct.pack(">H", restart_rows * mcux))
    out += sos([(ids[c], 0, 0) for c in range(n)], psv, 0, 0, pt)
    return out + _join(parts) + b"\xff\xd9"


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def _pillow(data):
    return np.asarray(Image.open(BytesIO(data)).convert("RGBA"))


def _assert_decodes_like_pillow(data):
    assert len(data) <= MAX_BYTES
    want = _pillow(data)
    got = jpeg.decode(data)
    assert got.dtype == np.uint8 and got.shape == want.shape == (H, W, 4)
    assert np.array_equal(got, want)


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


RGB = image(W, H)
YCC = to_ycc(RGB)
RESTARTS = [0, 2]
JFIF = segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")


def _ycc_frame(factors):
    return dct_coefs(YCC, factors, [0, 1, 1])


@pytest.mark.parametrize("restart", RESTARTS)
@pytest.mark.parametrize("factors", [[(1, 2), (1, 1), (1, 1)],
                                     [(4, 1), (1, 1), (1, 1)]],
                         ids=["440", "411"])
def test_sampling_equals_pillow(factors, restart):
    """jdsample.c's h1v2_fancy_upsample (4:4:0) and int_upsample
    (4:1:1)."""
    layout, coefs = _ycc_frame(factors)
    _assert_decodes_like_pillow(write_dct(
        layout, coefs, [1, 2, 3], [0, 1, 1], 0xC0, [([0, 1, 2], 0, 63, 0, 0)],
        restart, pre=JFIF))


@pytest.mark.parametrize("restart", [0, 3])
@pytest.mark.parametrize("progressive", [False, True],
                         ids=["baseline", "progressive"])
def test_ycck_equals_pillow(progressive, restart):
    """jdcolor.c:ycck_cmyk_convert, then Pillow's CMYK;I inversion and
    cmyk2rgb."""
    cmyk = image(W, H, 4, seed=3)
    planes = to_ycc(255 - cmyk[..., :3]) + [cmyk[..., 3]]
    layout, coefs = dct_coefs(planes, [(2, 2), (1, 1), (1, 1), (2, 2)],
                              [0, 1, 1, 0])
    scans = ([([0, 1, 2, 3], 0, 0, 0, 0)] + [([c], 1, 63, 0, 0)
                                             for c in range(4)]
             if progressive else [([0, 1, 2, 3], 0, 63, 0, 0)])
    _assert_decodes_like_pillow(write_dct(
        layout, coefs, [1, 2, 3, 4], [0, 1, 1, 0],
        0xC2 if progressive else 0xC0, scans, restart, pre=adobe(2)))


# jpeg_simple_progression's script for YCbCr, as libjpeg writes it
PROGRESSIVE = [([0, 1, 2], 0, 0, 0, 1), ([0], 1, 5, 0, 2),
               ([2], 1, 63, 0, 1), ([1], 1, 63, 0, 1), ([0], 6, 63, 0, 2),
               ([0], 1, 63, 2, 1), ([0, 1, 2], 0, 0, 1, 0),
               ([2], 1, 63, 1, 0), ([1], 1, 63, 1, 0), ([0], 1, 63, 1, 0)]
# DAC: L = 2, U = 5 for DC table 0, L = 1, U = 3 for DC table 1; K = 2 and
# 9 for AC tables 0 and 1
DAC = [(0, 0x52), (1, 0x31), (16, 2), (17, 9)]


@pytest.mark.parametrize("restart", RESTARTS)
@pytest.mark.parametrize("dac", [None, DAC], ids=["default", "dac"])
@pytest.mark.parametrize("kind", ["sequential-420", "sequential-440",
                                  "progressive-420", "progressive-444",
                                  "grey"])
def test_arithmetic_equals_pillow(kind, dac, restart):
    """jdarith.c: the QM decoder, DC and AC contexts and conditioning,
    the four progressive scan kinds, statistics reset at each restart."""
    factors = {"sequential-440": [(1, 2), (1, 1), (1, 1)],
               "progressive-444": [(1, 1)] * 3}.get(kind, [(2, 2), (1, 1),
                                                           (1, 1)])
    if kind == "grey":
        layout, coefs = dct_coefs(YCC[:1], [(1, 1)], [0])
        scans, ids, qsel = [([0], 0, 63, 0, 0)], [1], [0]
    else:
        layout, coefs = _ycc_frame(factors)
        ids, qsel = [1, 2, 3], [0, 1, 1]
        scans = (PROGRESSIVE if kind.startswith("progressive")
                 else [([0, 1, 2], 0, 63, 0, 0)])
    marker = 0xCA if kind.startswith("progressive") else 0xC9
    data = write_dct(layout, coefs, ids, qsel, marker, scans, restart,
                     dac=dac)
    _assert_decodes_like_pillow(data)
    if kind != "grey":     # the writer codes what it means to
        assert _psnr(jpeg.decode(data)[..., :3], RGB) > 19.0


@pytest.mark.parametrize("pt", [0, 2])
@pytest.mark.parametrize("psv", range(1, 8))
def test_lossless_equals_pillow(psv, pt):
    """jdlossls.c's predictors and point transform; without a JFIF or
    Adobe marker three components are read as RGB."""
    data = write_lossless(list(RGB.transpose(2, 0, 1)), psv, pt)
    _assert_decodes_like_pillow(data)
    got = jpeg.decode(data)[..., :3].astype(np.int64)
    assert np.array_equal(got, (RGB >> pt) << pt)


@pytest.mark.parametrize("case", ["grey-restart", "rgb-adobe-restart",
                                  "cmyk", "420-restart", "422", "440"])
def test_lossless_variants_equal_pillow(case):
    """Restart intervals of whole MCU rows (the first row of each
    predicts from 1 << (7 - pt)), an Adobe RGB marker, four components,
    subsampled components (MCUs of h x v samples, box upsampling)."""
    planes = list(RGB.transpose(2, 0, 1))
    sub = {"420-restart": (2, 2), "422": (2, 1), "440": (1, 2)}
    if case == "grey-restart":
        data = write_lossless([RGB[..., 1]], 7, 3, restart_rows=4, ids=(1,))
    elif case == "rgb-adobe-restart":
        data = write_lossless(planes, 4, 1, restart_rows=2, pre=adobe(0))
    elif case == "cmyk":
        data = write_lossless(list(image(W, H, 4, 5).transpose(2, 0, 1)), 6,
                              0, ids=(1, 2, 3, 4))
    else:
        data = write_lossless(planes, 5, 1, restart_rows=2 * (
            case == "420-restart"), factors=[sub[case], (1, 1), (1, 1)])
    _assert_decodes_like_pillow(data)


# progressive Huffman scripts that end before the last successive-
# approximation bit of the DC terms and of AC 1-9 (libjpeg smooths)
CUT = {
    # DC terms only, their last bit missing: the DC terms are
    # interpolated too
    "dc-only": [([0, 1, 2], 0, 0, 0, 1)],
    # every AC term to bit 1, no refinement scan
    "no-refine": [([0, 1, 2], 0, 0, 0, 1)]
    + [([c], 1, 5, 0, 1) for c in range(3)]
    + [([c], 6, 63, 0, 1) for c in range(3)],
    # DC and AC 1-2 complete, AC 3-63 to bit 2
    "partial": [([0, 1, 2], 0, 0, 0, 0)]
    + [([c], 1, 2, 0, 0) for c in range(3)]
    + [([c], 3, 63, 0, 2) for c in range(3)],
    # luma's AC terms to bit 1, chroma's never coded
    "luma-only": [([0, 1, 2], 0, 0, 0, 0), ([0], 1, 63, 0, 1)]}


@pytest.mark.parametrize("restart", RESTARTS)
@pytest.mark.parametrize("factors", [[(2, 2), (1, 1), (1, 1)],
                                     [(1, 2), (1, 1), (1, 1)]],
                         ids=["420", "440"])
@pytest.mark.parametrize("script", list(CUT))
def test_cut_progressive_equals_pillow(script, factors, restart):
    layout, coefs = _ycc_frame(factors)
    _assert_decodes_like_pillow(write_dct(
        layout, coefs, [1, 2, 3], [0, 1, 1], 0xC2, CUT[script], restart,
        pre=JFIF))


def test_cut_progressive_sizes_equal_pillow():
    """The smoothing's 5x5 neighbourhood at the edges of images of one
    and two blocks, of 64 rows in 4:4:0 (four iMCU rows) and of 40 rows
    in 4:2:0 (a last iMCU row one block row short), DC only."""
    for w, h, factors in ((8, 8, [(1, 1)] * 3),
                          (9, 57, [(2, 2), (1, 1), (1, 1)]),
                          (64, 64, [(1, 2), (1, 1), (1, 1)]),
                          (17, 40, [(2, 2), (1, 1), (1, 1)])):
        rgb = image(w, h, seed=w * h)
        layout, coefs = dct_coefs(to_ycc(rgb), factors, [0, 1, 1])
        data = write_dct(layout, coefs, [1, 2, 3], [0, 1, 1], 0xC2,
                         CUT["dc-only"], 0)
        assert np.array_equal(jpeg.decode(data), _pillow(data)), (w, h)


# ---------------------------------------------------------------------------
# what Pillow refuses: the port refuses it too
# ---------------------------------------------------------------------------

def _baseline():
    layout, coefs = _ycc_frame([(2, 2), (1, 1), (1, 1)])
    return write_dct(layout, coefs, [1, 2, 3], [0, 1, 1], 0xC0,
                     [([0, 1, 2], 0, 63, 0, 0)])


def _relabel(data, marker, new):
    i = data.index(bytes([0xFF, marker]))
    return data[:i + 1] + bytes([new]) + data[i + 2:]


def _refused():
    base = _baseline()
    sof_at = base.index(b"\xff\xc0")
    sof_end = sof_at + 2 + struct.unpack(">H", base[sof_at + 2:sof_at + 4])[0]
    lossless = write_lossless(list(RGB.transpose(2, 0, 1)), 1, 0)
    sos_at = lossless.index(b"\xff\xda")
    yield "hierarchical", base[:sof_at] + segment(
        0xDE, base[sof_at + 4:sof_end]) + b"\xff\xc5" + base[sof_at + 2:], \
        "hierarchical"
    for m in (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF):
        yield f"sof{m - 0xC0}", _relabel(base, 0xC0, m), "differential"
    yield "sof11", _relabel(lossless, 0xC3, 0xCB), "arithmetic-coded lossless"
    yield "12-bit", _relabel(base[:sof_at + 4] + b"\x0c" + base[sof_at + 5:],
                             0xC0, 0xC1), "12-bit"
    layout, coefs = dct_coefs(YCC[:2], [(1, 1), (1, 1)], [0, 1])
    yield "2-component", write_dct(layout, coefs, [1, 2], [0, 1], 0xC0,
                                   [([0, 1], 0, 63, 0, 0)]), "2-component"
    yield "dnl", base[:sof_at + 5] + b"\x00\x00" + base[sof_at + 7:-2] \
        + segment(0xDC, struct.pack(">H", H)) + b"\xff\xd9", "DNL"
    yield "fractional", base[:sof_at] + sof(
        0xC0, W, H, [(1, 3, 1, 0), (2, 2, 1, 1), (3, 1, 1, 1)]) \
        + base[sof_end:], "fractional"
    yield "lossless-restart", lossless[:sos_at] + segment(
        0xDD, struct.pack(">H", 5)) + lossless[sos_at:], "restart interval"
    yield "lossless-jfif", write_lossless(YCC, 1, 0, pre=JFIF), "YCbCr"
    yield "lossless-adobe-ycc", write_lossless(YCC, 1, 0, pre=adobe(1)), \
        "YCbCr"
    yield "lossless-ycck", write_lossless(
        list(image(W, H, 4).transpose(2, 0, 1)), 1, 0, ids=(1, 2, 3, 4),
        pre=adobe(2)), "YCCK"


REFUSED = {name: (data, words) for name, data, words in _refused()}


@pytest.mark.parametrize("name", list(REFUSED))
def test_modes_pillow_refuses_raise(name):
    data, words = REFUSED[name]
    with pytest.raises((OSError, SyntaxError)):
        _pillow(data)
    with pytest.raises(ValueError, match=words):
        jpeg.decode(data)
