"""Baseline JPEG decoding in numpy, byte-equal to libjpeg-turbo.

The port's stand-in for the PIL call of the reference's glTF loader
(`tpu_raytracer/scene/loader.py:_decode_image`, which returns
`np.asarray(Image.open(...).convert("RGBA"))`). `decode` repeats what
libjpeg-turbo 3.1.3 (the library Pillow 12.1.0 ships) does under its
defaults, stage by stage, so its RGBA bytes equal Pillow's:
  - the markers SOI, APPn (JFIF and Adobe read, the rest skipped), DQT,
    SOF0, SOF1 and SOF2, DHT, DRI, SOS, RSTn and EOI;
  - Huffman decoding with byte stuffing and restart intervals, of
    sequential scans and of the four progressive scan kinds (DC first
    and refine, AC first with end-of-band runs, AC refine with
    correction bits) into coefficients kept across the scans;
  - dequantization and the integer IDCT `jidctint.c:jpeg_idct_islow`
    (JDCT_ISLOW: CONST_BITS 13, PASS1_BITS 2, its range-limit table);
  - `jdsample.c`'s fancy upsampling of 4:2:2 (`h2v1_fancy_upsample`) and
    4:2:0 (`h2v2_fancy_upsample`) chroma, box upsampling where the
    subsampled width is 2 or less, edge rows and columns replicated;
  - `jdcolor.c:ycc_rgb_convert` in fixed point (SCALEBITS 16);
  - the blocks' padding cropped to the image size.
One component is grey (L, replicated into RGB); three are YCbCr, or RGB
where an Adobe marker says transform 0 or the component ids are 'R', 'G',
'B', as libjpeg reads them; four are CMYK (Adobe transform 0 or no Adobe
marker), inverted and converted as Pillow does it. Alpha is 255.

Arithmetic-coded, lossless, hierarchical and 12-bit streams, YCCK and 2-
component images, progressive streams that end before every
coefficient's last bit (libjpeg smooths their blocks) and sampling
factors other than 1x1, 2x1 and 2x2 relative to the largest (4:4:0,
4:1:1) raise ValueError naming what they are. The entropy decoder is
plain Python (a 16-bit lookup per code); the rest is numpy over all
blocks at once.
"""

from __future__ import annotations

import struct

import numpy as np

# jpeg_natural_order: zigzag index -> row-major position, padded with 63
# for a corrupt run past the block's end, as libjpeg pads it
_ZIGZAG = [
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]
_NATURAL = _ZIGZAG + [63] * 16

# jidctint.c
CONST_BITS, PASS1_BITS = 13, 2
_FIX = {"0_298631336": 2446, "0_390180644": 3196, "0_541196100": 4433,
        "0_765366865": 6270, "0_899976223": 7373, "1_175875602": 9633,
        "1_501321110": 12299, "1_847759065": 15137, "1_961570560": 16069,
        "2_053119869": 16819, "2_562915447": 20995, "3_072711026": 25172}

# jdcolor.c
SCALEBITS = 16
ONE_HALF = 1 << (SCALEBITS - 1)

_UNSUPPORTED = {
    0xC3: "lossless (SOF3)",
    0xC5: "differential sequential (SOF5)",
    0xC6: "differential progressive (SOF6)",
    0xC7: "differential lossless (SOF7)",
    0xC9: "arithmetic-coded sequential (SOF9)",
    0xCA: "arithmetic-coded progressive (SOF10)",
    0xCB: "arithmetic-coded lossless (SOF11)",
    0xCC: "arithmetic coding (DAC)",
    0xCD: "arithmetic-coded differential sequential (SOF13)",
    0xCE: "arithmetic-coded differential progressive (SOF14)",
    0xCF: "arithmetic-coded differential lossless (SOF15)",
    0xDE: "hierarchical (DHP)"}


def _fix(x: float) -> int:
    return int(x * (1 << SCALEBITS) + 0.5)


def _idct_range_limit() -> np.ndarray:
    """jdmaster.c:prepare_range_limit_table's post-IDCT part, indexed by
    (x & 1023) for a centred sample x: x + 128 clamped to 0..255 for
    -384 <= x < 384, and wrapped past that as libjpeg wraps it."""
    i = np.arange(1024)
    return np.where(i < 128, i + 128,
                    np.where(i < 512, 255,
                             np.where(i < 896, 0, i - 896))).astype(np.uint8)


_RANGE = _idct_range_limit()


def _huffman_table(counts, symbols) -> list:
    """A 65,536-entry lookup from the next 16 bits of the stream to
    (code length << 8 | symbol), 0 where no code matches (the canonical
    codes of JPEG Annex C)."""
    table = np.zeros(1 << 16, np.int64)
    code = k = 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lo = code << (16 - length)
            table[lo:lo + (1 << (16 - length))] = length << 8 | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return table.tolist()


def _segments(data: bytes, pos: int):
    """The entropy-coded data that starts at `pos`: its restart intervals
    with the byte stuffing removed, and the position of the marker that
    ends it."""
    out, start = [], pos
    while True:
        pos = data.find(b"\xff", pos)
        if pos < 0 or pos + 1 >= len(data):
            out.append(data[start:].replace(b"\xff\x00", b"\xff"))
            return out, len(data)
        nxt = data[pos + 1]
        if nxt == 0x00 or nxt == 0xFF:        # stuffed byte or fill byte
            pos += 1 if nxt == 0xFF else 2
        elif 0xD0 <= nxt <= 0xD7:            # RSTn
            out.append(data[start:pos].replace(b"\xff\x00", b"\xff"))
            pos += 2
            start = pos
        else:
            out.append(data[start:pos].replace(b"\xff\x00", b"\xff"))
            return out, pos


def _windows(segment: bytes) -> list:
    """w[i] = the 24 bits from byte i on, so the 16 bits at any bit
    position p are (w[p >> 3] >> (8 - (p & 7))) & 0xFFFF. Zero bits past
    the end stand in for missing data, as libjpeg inserts them."""
    b = np.frombuffer(segment + b"\0" * 8, np.uint8).astype(np.int64)
    return (b[:-2] << 16 | b[1:-1] << 8 | b[2:]).tolist()


class _Frame:
    def __init__(self, precision, height, width, comps, progressive):
        if precision != 8:
            raise ValueError(f"{precision}-bit JPEG is not supported (8-bit "
                             f"samples only)")
        if height == 0:
            raise ValueError("JPEG height set by a DNL marker is not "
                             "supported")
        if len(comps) not in (1, 3, 4):
            raise ValueError(f"{len(comps)}-component JPEG is not supported")
        self.progressive = progressive
        self.height, self.width = height, width
        self.ids = [c[0] for c in comps]
        self.h = [c[1] >> 4 for c in comps]
        self.v = [c[1] & 15 for c in comps]
        self.tq = [c[2] for c in comps]
        self.hmax, self.vmax = max(self.h), max(self.v)
        for h, v in zip(self.h, self.v):
            if (self.hmax // h, self.vmax // v) not in ((1, 1), (2, 1),
                                                       (2, 2)) \
                    or self.hmax % h or self.vmax % v:
                raise ValueError(f"JPEG sampling factors {h}x{v} of a "
                                 f"{self.hmax}x{self.vmax} image are not "
                                 f"supported")
        # MCUs of an interleaved scan, and each component's block grid
        # (the MCU-padded one) and its size in samples (jdinput.c)
        self.mcux = -(-width // (8 * self.hmax))
        self.mcuy = -(-height // (8 * self.vmax))
        self.dw = [-(-width * h // self.hmax) for h in self.h]
        self.dh = [-(-height * v // self.vmax) for v in self.v]
        self.bx = [self.mcux * h for h in self.h]
        self.by = [self.mcuy * v for v in self.v]
        # each component's coefficients, flat [by * bx * 64], kept across
        # the scans of a progressive stream, and the successive-
        # approximation bit each coefficient has reached (-1: none yet)
        self.coef = [[0] * (bx * by * 64) for bx, by in zip(self.bx,
                                                             self.by)]
        self.coef_bits = [[-1] * 64 for _ in comps]

    def blocks(self, c):
        """Component c's coefficients as an array [by, bx, 64]."""
        return np.asarray(self.coef[c], np.int64).reshape(
            self.by[c], self.bx[c], 64)


def _scan_layout(frame, idx):
    """The blocks of a scan over the components `idx`, MCU by MCU: lists
    of (k, block) with k the component's place in the scan and block its
    flat index in that component's grid. A scan of one component is not
    interleaved: its MCU is one block, over the component's own
    ceil(w / 8) x ceil(h / 8) blocks, not the MCU-padded grid."""
    if len(idx) == 1:
        c = idx[0]
        bw, bh = -(-frame.dw[c] // 8), -(-frame.dh[c] // 8)
        return [[(0, by * frame.bx[c] + bx)]
                for by in range(bh) for bx in range(bw)]
    layout = []
    for my in range(frame.mcuy):
        for mx in range(frame.mcux):
            mcu = []
            for k, c in enumerate(idx):
                h, v = frame.h[c], frame.v[c]
                mcu += [(k, (my * v + y) * frame.bx[c] + mx * h + x)
                        for y in range(v) for x in range(h)]
            layout.append(mcu)
    return layout


def _decode_scan(frame, scan, dc_tabs, ac_tabs, restart, segments):
    """Huffman-decode one scan into frame.coef: a sequential scan, or one
    of the four progressive kinds of ITU T.81 G.1.2 (DC first, DC refine,
    AC first with end-of-band runs, AC refine with correction bits), as
    jdhuff.c and jdphuff.c decode them. Every restart interval starts
    with the DC predictors and the end-of-band run at 0."""
    comps, ss, se, ah_al = scan
    ah, al = ah_al >> 4, ah_al & 15
    if frame.progressive:
        if ss > se or se > 63 or (ss == 0) != (se == 0) \
                or (ss > 0 and len(comps) != 1):
            raise ValueError("JPEG progressive scan has a bad spectral "
                             "selection")
    elif ss != 0 or se != 63 or ah_al != 0:
        raise ValueError("JPEG scan is not sequential (spectral selection "
                         "or successive approximation)")
    idx = [frame.ids.index(cid) for cid, _ in comps]
    dcs = [dc_tabs.get(t >> 4) for _, t in comps]
    acs = [ac_tabs.get(t & 15) for _, t in comps]
    for c in idx:
        frame.coef_bits[c][ss:se + 1] = [al] * (se + 1 - ss)
    if not frame.progressive:
        block_fn = _sequential_block
    elif ss == 0:
        block_fn = _dc_first_block if ah == 0 else _dc_refine_block
    else:
        block_fn = _ac_first_block if ah == 0 else _ac_refine_block
    layout = _scan_layout(frame, idx)
    flat = [frame.coef[c] for c in idx]
    per = restart or len(layout)
    for seg, first in enumerate(range(0, len(layout), per)):
        st = _ScanState(segments[seg] if seg < len(segments) else b"",
                        len(comps), ss, se, al)
        for mcu in layout[first:first + per]:
            for k, block in mcu:
                block_fn(st, flat[k], block * 64, k, dcs[k], acs[k])


class _ScanState:
    """One restart interval's bit reader (window table and position),
    DC predictors and end-of-band run."""

    def __init__(self, segment, ncomps, ss, se, al):
        self.win = _windows(segment)
        self.pos = 0
        self.pred = [0] * ncomps
        self.eobrun = 0
        self.ss, self.se, self.al = ss, se, al

    def huff(self, table):
        """The next Huffman symbol of `table`."""
        pos = self.pos
        e = table[(self.win[pos >> 3] >> (8 - (pos & 7))) & 0xFFFF] \
            if table is not None else 0
        if not e:
            raise ValueError("JPEG data: bad Huffman code")
        self.pos = pos + (e >> 8)
        return e & 0xFF

    def bits(self, n):
        """The next n <= 16 bits as an unsigned number."""
        if not n:
            return 0
        pos = self.pos
        self.pos = pos + n
        return ((self.win[pos >> 3] >> (8 - (pos & 7))) & 0xFFFF) \
            >> (16 - n)

    def extend(self, s):
        """The next s bits as a signed magnitude (jdhuff.h HUFF_EXTEND)."""
        val = self.bits(s)
        return val - (1 << s) + 1 if s and val < 1 << (s - 1) else val


def _sequential_block(st, out, base, k, dc, ac):
    win, natural = st.win, _NATURAL
    s = st.huff(dc)
    if s:
        st.pred[k] += st.extend(s)
    out[base] = st.pred[k]
    pos = st.pos
    i = 1
    while i < 64:
        e = ac[(win[pos >> 3] >> (8 - (pos & 7))) & 0xFFFF]
        if not e:
            raise ValueError("JPEG data: bad Huffman code")
        pos += e >> 8
        s = e & 15
        r = (e >> 4) & 15
        if s:
            i += r
            val = ((win[pos >> 3] >> (8 - (pos & 7))) & 0xFFFF) >> (16 - s)
            pos += s
            if val < 1 << (s - 1):
                val -= (1 << s) - 1
            out[base + natural[i]] = val
            i += 1
        elif r == 15:
            i += 16
        else:
            break
    st.pos = pos


def _dc_first_block(st, out, base, k, dc, ac):
    s = st.huff(dc)
    if s:
        st.pred[k] += st.extend(s)
    out[base] = st.pred[k] << st.al


def _dc_refine_block(st, out, base, k, dc, ac):
    if st.bits(1):
        out[base] |= 1 << st.al


def _ac_first_block(st, out, base, k, dc, ac):
    if st.eobrun:
        st.eobrun -= 1
        return
    i = st.ss
    while i <= st.se:
        rs = st.huff(ac)
        r, s = rs >> 4, rs & 15
        if s:
            i += r
            out[base + _NATURAL[i]] = st.extend(s) << st.al
        elif r == 15:
            i += 15
        else:
            st.eobrun = (1 << r) + st.bits(r) - 1
            return
        i += 1


def _ac_refine_block(st, out, base, k, dc, ac):
    """jdphuff.c:decode_mcu_AC_refine: new coefficients of magnitude
    1 << al, and one correction bit for each already-nonzero coefficient
    passed over."""
    p1, m1 = 1 << st.al, -1 << st.al
    natural = _NATURAL
    i, se = st.ss, st.se

    def correct(j):
        if st.bits(1) and not out[j] & p1:
            out[j] += p1 if out[j] >= 0 else m1

    if not st.eobrun:
        while i <= se:
            rs = st.huff(ac)
            r, s = rs >> 4, rs & 15
            if s:
                s = p1 if st.bits(1) else m1
            elif r != 15:
                st.eobrun = (1 << r) + st.bits(r)
                break
            while i <= se:
                j = base + natural[i]
                if out[j]:
                    correct(j)
                else:
                    r -= 1
                    if r < 0:
                        break
                i += 1
            if s:
                out[base + natural[i]] = s
            i += 1
    if st.eobrun:
        while i <= se:
            j = base + natural[i]
            if out[j]:
                correct(j)
            i += 1
        st.eobrun -= 1


def _idct_1d(x):
    """One pass of jpeg_idct_islow over the 8 arrays x[0..7] (the
    coefficients of one column, or one row of the workspace); returns
    the 8 outputs before their descale."""
    fix = _FIX
    z1 = (x[2] + x[6]) * fix["0_541196100"]
    tmp2 = z1 + x[6] * -fix["1_847759065"]
    tmp3 = z1 + x[2] * fix["0_765366865"]
    tmp0 = (x[0] + x[4]) << CONST_BITS
    tmp1 = (x[0] - x[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * fix["1_175875602"]
    t0 = t0 * fix["0_298631336"]
    t1 = t1 * fix["2_053119869"]
    t2 = t2 * fix["3_072711026"]
    t3 = t3 * fix["1_501321110"]
    z1 = z1 * -fix["0_899976223"]
    z2 = z2 * -fix["2_562915447"]
    z3 = z3 * -fix["1_961570560"] + z5
    z4 = z4 * -fix["0_390180644"] + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _idct_islow(coef, quant):
    """coef [..., 64] row-major, quant [64] row-major -> samples [..., 8,
    8] uint8, as jpeg_idct_islow computes them (its shortcuts for zero AC
    terms give the same values as the full passes)."""
    c = (coef * quant).reshape(*coef.shape[:-1], 8, 8)
    # pass 1: columns (the vertical frequencies, axis -2)
    cols = _idct_1d([c[..., k, :] for k in range(8)])
    ws = np.stack([_descale(x, CONST_BITS - PASS1_BITS) for x in cols],
                  axis=-2)
    # pass 2: rows of the workspace
    rows = _idct_1d([ws[..., k] for k in range(8)])
    out = np.stack([_descale(x, CONST_BITS + PASS1_BITS + 3) for x in rows],
                   axis=-1)
    return _RANGE[out & 1023]


def _edges(p, axis):
    """(previous, next) neighbours of p along `axis`, the edge samples
    repeated."""
    n = p.shape[axis]
    prev = np.take(p, np.r_[0, 0:n - 1], axis=axis)
    nxt = np.take(p, np.r_[1:n, n - 1], axis=axis)
    return prev, nxt


def _interleave(a, b, axis):
    out = np.stack([a, b], axis=axis + 1)
    shape = list(a.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def _upsample(p, hr, vr):
    """A component plane [dh, dw] to the luma's grid, as jdsample.c does
    under do_fancy_upsampling: h2v1_fancy_upsample (3/4, 1/4 with biases
    1 and 2) and h2v2_fancy_upsample (9/16, 3/16, 3/16, 1/16 with biases 8
    and 7) where the plane is wider than 2 samples, else box upsampling.
    The edge samples stand in for the ones past the image, as libjpeg's
    context rows and edge cases make them."""
    p = p.astype(np.int64)
    if (hr, vr) == (1, 1):
        return p
    if p.shape[1] <= 2:
        return p.repeat(vr, axis=0).repeat(hr, axis=1)
    if vr == 1:
        left, right = _edges(p, 1)
        return _interleave((3 * p + left + 1) >> 2, (3 * p + right + 2) >> 2,
                           1)
    above, below = _edges(p, 0)
    cs = _interleave(3 * p + above, 3 * p + below, 0)
    left, right = _edges(cs, 1)
    return _interleave((3 * cs + left + 8) >> 4, (3 * cs + right + 7) >> 4,
                       1)


def _ycc_to_rgb(y, cb, cr):
    """jdcolor.c:ycc_rgb_convert with its tables."""
    x = np.arange(256, dtype=np.int64) - 128
    cr_r = (_fix(1.40200) * x + ONE_HALF) >> SCALEBITS
    cb_b = (_fix(1.77200) * x + ONE_HALF) >> SCALEBITS
    cr_g = -_fix(0.71414) * x
    cb_g = -_fix(0.34414) * x + ONE_HALF
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> SCALEBITS)
    b = y + cb_b[cb]
    return [np.clip(c, 0, 255) for c in (r, g, b)]


def decode(data: bytes) -> np.ndarray:
    """JPEG bytes -> RGBA uint8 [H, W, 4], byte-equal to Pillow's
    `np.asarray(Image.open(BytesIO(data)).convert("RGBA"))`. Raises
    ValueError on what it does not take, naming it."""
    data = bytes(data)
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG stream (no SOI marker)")
    quant, dc_tabs, ac_tabs = {}, {}, {}
    frame, restart, jfif, adobe = None, 0, False, None
    pos = 2
    while True:
        pos = data.find(b"\xff", pos)
        while 0 <= pos < len(data) - 1 and data[pos + 1] == 0xFF:
            pos += 1                             # fill bytes
        if pos < 0 or pos + 1 >= len(data):
            break                               # no EOI: stop at the end
        marker = data[pos + 1]
        pos += 2
        if marker == 0xD9:                      # EOI
            break
        if 0xD0 <= marker <= 0xD8 or marker == 0x01:
            continue                            # stray RSTn / SOI / TEM
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        body, pos = data[pos + 2:pos + length], pos + length
        if marker in _UNSUPPORTED:
            raise ValueError(f"{_UNSUPPORTED[marker]} JPEG is not supported")
        if marker == 0xE0 and body[:5] == b"JFIF\0":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif marker == 0xDB:                    # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                n = 128 if pq else 64
                zz = np.frombuffer(body[i + 1:i + 1 + n],
                                   ">u2" if pq else np.uint8)
                q = np.zeros(64, np.int64)
                q[_ZIGZAG] = zz
                quant[tq] = q
                i += 1 + n
        elif marker == 0xC4:                    # DHT
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = body[i + 1:i + 17]
                n = sum(counts)
                table = _huffman_table(counts, body[i + 17:i + 17 + n])
                (ac_tabs if tc else dc_tabs)[th] = table
                i += 17 + n
        elif marker == 0xDD:                    # DRI
            (restart,) = struct.unpack(">H", body[:2])
        elif marker in (0xC0, 0xC1, 0xC2):      # SOF0, SOF1, SOF2
            p, h, w, nf = struct.unpack(">BHHB", body[:6])
            frame = _Frame(p, h, w, [tuple(body[6 + 3 * k:9 + 3 * k])
                                     for k in range(nf)], marker == 0xC2)
        elif marker == 0xDA:                    # SOS
            if frame is None:
                raise ValueError("JPEG scan before its frame header")
            ns = body[0]
            comps = [tuple(body[1 + 2 * k:3 + 2 * k]) for k in range(ns)]
            scan = (comps, *body[1 + 2 * ns:4 + 2 * ns])
            segments, pos = _segments(data, pos)
            _decode_scan(frame, scan, dc_tabs, ac_tabs, restart, segments)
    if frame is None:
        raise ValueError("JPEG stream has no frame header")
    return _to_rgba(frame, quant, jfif, adobe)


def _to_rgba(frame, quant, jfif, adobe):
    if frame.progressive:
        # libjpeg smooths the blocks (jdcoefct.c:decompress_smooth_data)
        # only while a component's DC or first nine AC terms are
        # unfinished; a complete stream ends every one at bit 0
        for bits in frame.coef_bits:
            if bits[0] >= 0 and any(b != 0 for b in bits[:10]):
                raise ValueError("incomplete progressive JPEG (block "
                                 "smoothing) is not supported")
    if len(frame.ids) == 4 and adobe not in (None, 0):
        raise ValueError("4-component YCCK JPEG is not supported")
    planes = []
    for c in range(len(frame.ids)):
        coef = frame.blocks(c)
        by, bx = coef.shape[:2]
        s = _idct_islow(coef, quant[frame.tq[c]])      # [by, bx, 8, 8]
        s = s.transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)
        s = s[:frame.dh[c], :frame.dw[c]]
        up = _upsample(s, frame.hmax // frame.h[c], frame.vmax // frame.v[c])
        planes.append(up[:frame.height, :frame.width])
    if len(planes) == 1:
        rgb = planes * 3
    elif len(planes) == 4:
        rgb = _cmyk_to_rgb(planes)
    elif not jfif and (adobe == 0 or (adobe is None and bytes(frame.ids)
                                      == b"RGB")):
        rgb = planes                    # stored as RGB (jdapimin.c)
    else:
        rgb = _ycc_to_rgb(*planes)
    alpha = np.full((frame.height, frame.width), 255)
    return np.stack([*rgb, alpha], axis=-1).astype(np.uint8)


def _cmyk_to_rgb(planes):
    """Pillow's reading of a CMYK JPEG: the samples inverted (raw mode
    CMYK;I, Adobe's convention), then Convert.c:cmyk2rgb, which scales
    each of C, M, Y by the inverse of K with MULDIV255 rounding."""
    c, m, y, k = (255 - p for p in planes)
    nk = 255 - k

    def muldiv255(a, b):
        t = a * b + 128
        return ((t >> 8) + t) >> 8

    return [np.clip(nk - muldiv255(p, nk), 0, 255) for p in (c, m, y)]


def _time_decode(size: int = 1024, seed: int = 0) -> None:
    """Encode a seeded size^2 4:2:0 image with Pillow at quality 75, as a
    baseline and as a progressive stream, decode each with `decode`,
    check it against Pillow and print the host seconds. Pillow is
    imported here only: the decoder needs none."""
    import time
    from io import BytesIO

    from PIL import Image

    g = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:size]
    img = np.stack([x % 256, y % 256, (x * y) % 256], axis=-1)
    img = np.clip(img + g.integers(-20, 21, img.shape), 0, 255)
    for progressive in (False, True):
        buf = BytesIO()
        Image.fromarray(img.astype(np.uint8)).save(
            buf, format="JPEG", subsampling=2, quality=75,
            progressive=progressive)
        data = buf.getvalue()
        t0 = time.perf_counter()
        got = decode(data)
        dt = time.perf_counter() - t0
        want = np.asarray(Image.open(BytesIO(data)).convert("RGBA"))
        kind = "progressive" if progressive else "baseline"
        print(f"decode {size}x{size} 4:2:0 q75 {kind} ({len(data)} bytes): "
              f"{dt:.3f} s on the host, equal to Pillow: "
              f"{np.array_equal(got, want)}")


if __name__ == "__main__":
    # python -m tpu_raytracer_torch.utils.jpeg: the decoder's host time
    _time_decode()
