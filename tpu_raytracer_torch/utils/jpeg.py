"""JPEG decoding in numpy, byte-equal to libjpeg-turbo.

The port's stand-in for the PIL call of the reference's glTF loader
(`tpu_raytracer/scene/loader.py:_decode_image`, which returns
`np.asarray(Image.open(...).convert("RGBA"))`). `decode` repeats what
libjpeg-turbo 3.1.3 (the library Pillow 12.1.0 ships) does under its
defaults, stage by stage, so its RGBA bytes equal Pillow's:
  - the markers SOI, APPn (JFIF and Adobe read, the rest skipped), DQT,
    SOF0-SOF3, SOF9 and SOF10, DHT, DAC, DRI, SOS, RSTn and EOI;
  - Huffman decoding with byte stuffing and restart intervals, of
    sequential scans and of the four progressive scan kinds (DC first
    and refine, AC first with end-of-band runs, AC refine with
    correction bits) into coefficients kept across the scans
    (jdhuff.c, jdphuff.c);
  - arithmetic decoding of the same scans (jdarith.c): the QM decoder of
    ITU T.81 Annex D, its statistics bins and DC/AC contexts under the
    DAC marker's conditioning (default L 0, U 1, K 5);
  - lossless frames (SOF3; jdlhuff.c, jddiffct.c, jdlossls.c):
    predictors 1-7, the point transform, restart intervals of whole MCU
    rows, box upsampling of subsampled components, and no colour
    conversion (three components are RGB, four CMYK; a JFIF or Adobe
    YCbCr/YCCK marker raises, as libjpeg-turbo refuses to convert colour
    in lossless mode);
  - dequantization and the integer IDCT `jidctint.c:jpeg_idct_islow`
    (JDCT_ISLOW: CONST_BITS 13, PASS1_BITS 2, its range-limit table);
  - block smoothing of progressive streams that end before the last bit
    of a component's DC term or of its first nine AC terms
    (`jdcoefct.c:decompress_smooth_data`, in the 5x5 form 3.1.3 ships);
  - `jdsample.c`'s fancy upsampling of 4:2:2 (`h2v1_fancy_upsample`),
    4:2:0 (`h2v2_fancy_upsample`) and 4:4:0 (`h1v2_fancy_upsample`)
    chroma, box upsampling for any other integral ratio (4:1:1,
    `int_upsample`) and where a 4:2:2 or 4:2:0 plane is 2 samples wide or
    less, edge rows and columns replicated;
  - `jdcolor.c:ycc_rgb_convert` in fixed point (SCALEBITS 16), and
    `ycck_cmyk_convert` for YCCK;
  - the blocks' padding cropped to the image size.
One component is grey (L, replicated into RGB); three are YCbCr, or RGB
where an Adobe marker says transform 0 or the component ids are 'R', 'G',
'B', as libjpeg reads them; four are CMYK (Adobe transform 0 or no Adobe
marker) or YCCK (any other transform), inverted and converted as Pillow
does it. Alpha is 255.

What libjpeg-turbo refuses raises ValueError naming it: hierarchical and
differential frames (DHP, SOF5-7, SOF13-15), arithmetic-coded lossless
(SOF11), 12-bit samples, 2-component images, a height set by DNL, and
fractional sampling ratios; so does corrupt entropy-coded data, where
libjpeg warns and goes on. The entropy decoders are plain Python (a
16-bit lookup per Huffman code, a decision at a time for the arithmetic
coder); the rest is numpy over all blocks at once.
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

# the frame types libjpeg-turbo 3.1.3 refuses too (jdmarker.c:read_markers)
_UNSUPPORTED = {
    0xC5: "differential sequential (SOF5)",
    0xC6: "differential progressive (SOF6)",
    0xC7: "differential lossless (SOF7)",
    0xC8: "extension (JPG)",
    0xCB: "arithmetic-coded lossless (SOF11)",
    0xCD: "arithmetic-coded differential sequential (SOF13)",
    0xCE: "arithmetic-coded differential progressive (SOF14)",
    0xCF: "arithmetic-coded differential lossless (SOF15)",
    0xDE: "hierarchical (DHP)"}
# SOFn -> (progressive, arithmetic-coded, lossless)
_SOF = {0xC0: (False, False, False), 0xC1: (False, False, False),
        0xC2: (True, False, False), 0xC3: (False, False, True),
        0xC9: (False, True, False), 0xCA: (True, True, False)}

# ITU T.81 Table D.2, the QM coder's probability estimation, as jaricom.c
# holds it (with its state 113, a fixed probability of one half): per
# state (Qe, next state after an MPS, next state after an LPS, whether an
# LPS switches the MPS)
_QE = (
    (0x5A1D, 1, 1, 1), (0x2586, 2, 14, 0), (0x1114, 3, 16, 0),
    (0x080B, 4, 18, 0), (0x03D8, 5, 20, 0), (0x01DA, 6, 23, 0),
    (0x00E5, 7, 25, 0), (0x006F, 8, 28, 0), (0x0036, 9, 30, 0),
    (0x001A, 10, 33, 0), (0x000D, 11, 35, 0), (0x0006, 12, 9, 0),
    (0x0003, 13, 10, 0), (0x0001, 13, 12, 0), (0x5A7F, 15, 15, 1),
    (0x3F25, 16, 36, 0), (0x2CF2, 17, 38, 0), (0x207C, 18, 39, 0),
    (0x17B9, 19, 40, 0), (0x1182, 20, 42, 0), (0x0CEF, 21, 43, 0),
    (0x09A1, 22, 45, 0), (0x072F, 23, 46, 0), (0x055C, 24, 48, 0),
    (0x0406, 25, 49, 0), (0x0303, 26, 51, 0), (0x0240, 27, 52, 0),
    (0x01B1, 28, 54, 0), (0x0144, 29, 56, 0), (0x00F5, 30, 57, 0),
    (0x00B7, 31, 59, 0), (0x008A, 32, 60, 0), (0x0068, 33, 62, 0),
    (0x004E, 34, 63, 0), (0x003B, 35, 32, 0), (0x002C, 9, 33, 0),
    (0x5AE1, 37, 37, 1), (0x484C, 38, 64, 0), (0x3A0D, 39, 65, 0),
    (0x2EF1, 40, 67, 0), (0x261F, 41, 68, 0), (0x1F33, 42, 69, 0),
    (0x19A8, 43, 70, 0), (0x1518, 44, 72, 0), (0x1177, 45, 73, 0),
    (0x0E74, 46, 74, 0), (0x0BFB, 47, 75, 0), (0x09F8, 48, 77, 0),
    (0x0861, 49, 78, 0), (0x0706, 50, 79, 0), (0x05CD, 51, 48, 0),
    (0x04DE, 52, 50, 0), (0x040F, 53, 50, 0), (0x0363, 54, 51, 0),
    (0x02D4, 55, 52, 0), (0x025C, 56, 53, 0), (0x01F8, 57, 54, 0),
    (0x01A4, 58, 55, 0), (0x0160, 59, 56, 0), (0x0125, 60, 57, 0),
    (0x00F6, 61, 58, 0), (0x00CB, 62, 59, 0), (0x00AB, 63, 61, 0),
    (0x008F, 32, 61, 0), (0x5B12, 65, 65, 1), (0x4D04, 66, 80, 0),
    (0x412C, 67, 81, 0), (0x37D8, 68, 82, 0), (0x2FE8, 69, 83, 0),
    (0x293C, 70, 84, 0), (0x2379, 71, 86, 0), (0x1EDF, 72, 87, 0),
    (0x1AA9, 73, 87, 0), (0x174E, 74, 72, 0), (0x1424, 75, 72, 0),
    (0x119C, 76, 74, 0), (0x0F6B, 77, 74, 0), (0x0D51, 78, 75, 0),
    (0x0BB6, 79, 77, 0), (0x0A40, 48, 77, 0), (0x5832, 81, 80, 1),
    (0x4D1C, 82, 88, 0), (0x438E, 83, 89, 0), (0x3BDD, 84, 90, 0),
    (0x34EE, 85, 91, 0), (0x2EAE, 86, 92, 0), (0x299A, 87, 93, 0),
    (0x2516, 71, 86, 0), (0x5570, 89, 88, 1), (0x4CA9, 90, 95, 0),
    (0x44D9, 91, 96, 0), (0x3E22, 92, 97, 0), (0x3824, 93, 99, 0),
    (0x32B4, 94, 99, 0), (0x2E17, 86, 93, 0), (0x56A8, 96, 95, 1),
    (0x4F46, 97, 101, 0), (0x47E5, 98, 102, 0), (0x41CF, 99, 103, 0),
    (0x3C3D, 100, 104, 0), (0x375E, 93, 99, 0), (0x5231, 102, 105, 0),
    (0x4C0F, 103, 106, 0), (0x4639, 104, 107, 0), (0x415E, 99, 103, 0),
    (0x5627, 106, 105, 1), (0x50E7, 107, 108, 0), (0x4B85, 103, 109, 0),
    (0x5597, 109, 110, 0), (0x504F, 107, 111, 0), (0x5A10, 111, 110, 1),
    (0x5522, 109, 112, 0), (0x59EB, 111, 112, 1), (0x5A1D, 113, 113, 0),
)


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
    def __init__(self, precision, height, width, comps, kind):
        if precision != 8:
            raise ValueError(f"{precision}-bit JPEG is not supported (8-bit "
                             f"samples only)")
        if height == 0:
            raise ValueError("JPEG height set by a DNL marker is not "
                             "supported")
        if len(comps) not in (1, 3, 4):
            raise ValueError(f"{len(comps)}-component JPEG is not supported")
        self.progressive, self.arith, self.lossless = kind
        self.height, self.width = height, width
        self.ids = [c[0] for c in comps]
        self.h = [c[1] >> 4 for c in comps]
        self.v = [c[1] & 15 for c in comps]
        self.tq = [c[2] for c in comps]
        self.hmax, self.vmax = max(self.h), max(self.v)
        for h, v in zip(self.h, self.v):
            if not (1 <= h <= 4 and 1 <= v <= 4):
                raise ValueError(f"JPEG sampling factors {h}x{v} are out of "
                                 f"range")
            if self.hmax % h or self.vmax % v:
                raise ValueError(f"JPEG sampling factors {h}x{v} of a "
                                 f"{self.hmax}x{self.vmax} image are not "
                                 f"integral (fractional upsampling)")
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
        # approximation bit each coefficient has reached (-1: none yet);
        # a lossless frame keeps each component's samples [dh, dw]
        self.coef = [] if self.lossless else [
            [0] * (bx * by * 64) for bx, by in zip(self.bx, self.by)]
        self.coef_bits = [[-1] * 64 for _ in comps]
        self.samples = [None] * len(comps)

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


def _decode_scan(frame, scan, tables, restart, segments):
    """Decode one scan into frame.coef: a sequential scan, or one of the
    four progressive kinds of ITU T.81 G.1.2 (DC first, DC refine, AC
    first, AC refine), Huffman-coded as jdhuff.c and jdphuff.c decode
    them or arithmetic-coded as jdarith.c does; a lossless scan into
    frame.samples (`_decode_lossless_scan`). Every restart interval
    starts with the DC predictors at 0, the end-of-band run at 0 and,
    arithmetic-coded, the statistics of the scan's tables at 0.
    tables: (DC Huffman tables, AC Huffman tables, arithmetic
    conditioning (L, U, K) by table)."""
    comps, ss, se, ah_al = scan
    ah, al = ah_al >> 4, ah_al & 15
    idx = [frame.ids.index(cid) for cid, _ in comps]
    if frame.lossless:
        _decode_lossless_scan(frame, idx, [tables[0].get(t >> 4)
                                           for _, t in comps],
                              ss, se, ah, al, restart, segments)
        return
    if frame.progressive:
        if ss > se or se > 63 or (ss == 0) != (se == 0) \
                or (ss > 0 and len(comps) != 1):
            raise ValueError("JPEG progressive scan has a bad spectral "
                             "selection")
    elif ss != 0 or se != 63 or ah_al != 0:
        raise ValueError("JPEG scan is not sequential (spectral selection "
                         "or successive approximation)")
    for c in idx:
        frame.coef_bits[c][ss:se + 1] = [al] * (se + 1 - ss)
    kind = (0 if not frame.progressive else 1 + (ss > 0) * 2 + (ah > 0))
    if frame.arith:
        dcs = [t >> 4 for _, t in comps]
        acs = [t & 15 for _, t in comps]
        block_fn = _ARITH_BLOCKS[kind]
    else:
        dcs = [tables[0].get(t >> 4) for _, t in comps]
        acs = [tables[1].get(t & 15) for _, t in comps]
        block_fn = _HUFFMAN_BLOCKS[kind]
    layout = _scan_layout(frame, idx)
    flat = [frame.coef[c] for c in idx]
    per = restart or len(layout)
    for seg, first in enumerate(range(0, len(layout), per)):
        data = segments[seg] if seg < len(segments) else b""
        if frame.arith:
            st = _ArithState(data, len(comps), ss, se, al, tables[2],
                             dcs, acs)
        else:
            st = _ScanState(data, len(comps), ss, se, al)
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


_HUFFMAN_BLOCKS = (_sequential_block, _dc_first_block, _dc_refine_block,
                   _ac_first_block, _ac_refine_block)


class _ArithState:
    """One restart interval of an arithmetic-coded scan, as jdarith.c
    decodes it: the QM decoder's registers over the interval's bytes
    (zeros past them, as libjpeg supplies after a marker), the scan's
    statistics bins at 0, the fixed bin, DC predictors and contexts.
    A statistics bin holds a state of _QE and the MPS in bit 7."""

    def __init__(self, segment, ncomps, ss, se, al, cond, dcs, acs):
        self.data, self.i = segment, 0
        self.c, self.a, self.ct = 0, 0, -16
        self.dc_stats = {t: [0] * 64 for t in dcs}
        self.ac_stats = {t: [0] * 256 for t in acs}
        self.fixed = [113]
        self.last = [0] * ncomps
        self.ctx = [0] * ncomps
        self.ss, self.se, self.al = ss, se, al
        self.cond = cond

    def decode(self, st, i):
        """jdarith.c:arith_decode: the next decision coded with bin
        st[i], which it updates."""
        while self.a < 0x8000:
            self.ct -= 1
            if self.ct < 0:
                data = self.data[self.i] if self.i < len(self.data) else 0
                self.i += 1
                self.c = self.c << 8 | data
                self.ct += 8
                if self.ct < 0:
                    self.ct += 1
                    if self.ct == 0:
                        self.a = 0x8000
            self.a <<= 1
        sv = st[i]
        qe, nm, nl, sw = _QE[sv & 0x7F]
        nl |= sw << 7
        self.a -= qe
        temp = self.a << self.ct
        if self.c >= temp:
            self.c -= temp
            if self.a < qe:
                st[i] = (sv & 0x80) ^ nm
            else:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            self.a = qe
        elif self.a < 0x8000:
            if self.a < qe:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ nm
        return sv >> 7

    def magnitude(self, st, i, m, wide):
        """The rest of a magnitude category that starts at m (F.23)
        from bin `wide` on, then its bit pattern (F.24) with bins i + 14:
        returns v - 1 of a coded value v."""
        if m and wide is not None:
            i = wide
            while self.decode(st, i):
                m <<= 1
                if m == 0x8000:
                    raise ValueError("JPEG data: bad arithmetic code")
                i += 1
        v = m
        i += 14
        m >>= 1
        while m:
            if self.decode(st, i):
                v |= m
            m >>= 1
        return v

    def dc(self, k, tbl):
        """F.19-F.24: component k's DC difference, added to its predictor
        modulo 2^16 (jdarith.c); returns the predictor."""
        st, i = self.dc_stats[tbl], self.ctx[k]
        if not self.decode(st, i):
            self.ctx[k] = 0
            return self.last[k]
        sign = self.decode(st, i + 1)
        i += 2 + sign
        m = self.decode(st, i)
        if m:
            st_i = 20
            while self.decode(st, st_i):
                m <<= 1
                if m == 0x8000:
                    raise ValueError("JPEG data: bad arithmetic code")
                st_i += 1
            i = st_i
        lo, hi, _ = self.cond[tbl]
        if m < (1 << lo) >> 1:
            self.ctx[k] = 0
        elif m > (1 << hi) >> 1:
            self.ctx[k] = 12 + sign * 4
        else:
            self.ctx[k] = 4 + sign * 4
        v = self.magnitude(st, i, m, None) + 1
        self.last[k] = (self.last[k] + (-v if sign else v)) & 0xFFFF
        return self.last[k]

    def ac(self, tbl, k, i):
        """F.21-F.24 at coefficient k once its nonzero decision is made
        with bins from i: the signed value."""
        st = self.ac_stats[tbl]
        sign = self.decode(self.fixed, 0)
        i += 2
        m = self.decode(st, i)
        wide = None
        if m and self.decode(st, i):
            m <<= 1
            wide = 189 if k <= self.cond[tbl][2] else 217
        v = self.magnitude(st, i, m, wide) + 1
        return -v if sign else v


def _signed16(x):
    x &= 0xFFFF
    return x - 0x10000 if x & 0x8000 else x


def _arith_sequential_block(st, out, base, k, dc, ac):
    out[base] = _signed16(st.dc(k, dc))
    _arith_ac_run(st, out, base, ac, 1, 63, 0)


def _arith_ac_run(st, out, base, ac, ss, se, al):
    """F.20: the AC coefficients ss..se of a block, each shifted by al."""
    stats, natural = st.ac_stats[ac], _NATURAL
    k = ss
    while k <= se:
        i = 3 * (k - 1)
        if st.decode(stats, i):
            break                                      # end of block
        while not st.decode(stats, i + 1):
            i += 3
            k += 1
            if k > se:
                raise ValueError("JPEG data: bad arithmetic code")
        out[base + natural[k]] = _signed16(st.ac(ac, k, i) << al)
        k += 1


def _arith_dc_first_block(st, out, base, k, dc, ac):
    out[base] = _signed16(st.dc(k, dc) << st.al)


def _arith_dc_refine_block(st, out, base, k, dc, ac):
    if st.decode(st.fixed, 0):
        out[base] |= 1 << st.al


def _arith_ac_first_block(st, out, base, k, dc, ac):
    _arith_ac_run(st, out, base, ac, st.ss, st.se, st.al)


def _arith_ac_refine_block(st, out, base, k, dc, ac):
    """jdarith.c:decode_mcu_AC_refine: a correction bit for each
    coefficient already nonzero, new ones of magnitude 1 << al."""
    stats, natural = st.ac_stats[ac], _NATURAL
    p1, m1 = 1 << st.al, -1 << st.al
    kex = st.se
    while kex > 0 and not out[base + natural[kex]]:
        kex -= 1
    k = st.ss
    while k <= st.se:
        i = 3 * (k - 1)
        if k > kex and st.decode(stats, i):
            break                                      # end of block
        while True:
            j = base + natural[k]
            if out[j]:
                if st.decode(stats, i + 2):
                    out[j] += m1 if out[j] < 0 else p1
                break
            if st.decode(stats, i + 1):
                out[j] = m1 if st.decode(st.fixed, 0) else p1
                break
            i += 3
            k += 1
            if k > st.se:
                raise ValueError("JPEG data: bad arithmetic code")
        k += 1


_ARITH_BLOCKS = (_arith_sequential_block, _arith_dc_first_block,
                 _arith_dc_refine_block, _arith_ac_first_block,
                 _arith_ac_refine_block)


def _decode_lossless_scan(frame, idx, dcs, psv, se, ah, pt, restart,
                          segments):
    """A lossless scan (ITU T.81 Annex H) as jdlhuff.c, jddiffct.c and
    jdlossls.c decode it: one Huffman-coded difference a sample (category
    16: 32768), in MCUs of h x v samples a component (one sample in a
    scan of one component), then undone row by row over each
    component's own dh x dw samples with predictor `psv`. The first row
    of the scan and of every restart interval predicts its first sample
    from 1 << (7 - pt) and the rest from the left; every later row its
    first sample from above. Samples are kept modulo 2^16 and scaled back
    by the point transform pt into 8 bits."""
    if not 1 <= psv <= 7 or se != 0 or ah != 0 or pt >= 8:
        raise ValueError(f"JPEG lossless scan has bad parameters (predictor "
                         f"{psv}, Se {se}, Ah {ah}, Al {pt})")
    if len(idx) == 1:
        hs = vs = [1]
        mcux, mcuy = frame.dw[idx[0]], frame.dh[idx[0]]
    else:
        hs, vs = [frame.h[c] for c in idx], [frame.v[c] for c in idx]
        mcux = -(-frame.width // frame.hmax)
        mcuy = -(-frame.height // frame.vmax)
    if restart % mcux:
        raise ValueError(f"JPEG lossless restart interval {restart} is not "
                         f"a multiple of the {mcux} MCUs of a row")
    per = restart // mcux or mcuy                   # MCU rows an interval
    diff = [np.zeros((mcuy * v, mcux * h), np.int64)
            for h, v in zip(hs, vs)]
    for seg, my0 in enumerate(range(0, mcuy, per)):
        st = _ScanState(segments[seg] if seg < len(segments) else b"",
                        len(idx), 0, 0, 0)
        for my in range(my0, min(my0 + per, mcuy)):
            for mx in range(mcux):
                for k, (h, v) in enumerate(zip(hs, vs)):
                    for y in range(my * v, my * v + v):
                        for x in range(mx * h, mx * h + h):
                            s = st.huff(dcs[k])
                            diff[k][y, x] = 32768 if s == 16 \
                                else st.extend(s)
    for k, c in enumerate(idx):
        rows, first = [], set(range(0, mcuy * vs[k], per * vs[k]))
        for y in range(frame.dh[c]):
            row = diff[k][y, :frame.dw[c]].tolist()
            rows.append(_undifference(row, None if y in first
                                      else rows[-1], psv, pt))
        frame.samples[c] = (np.asarray(rows, np.int64) << pt) & 0xFF


def _undifference(diff, prev, psv, pt):
    """jdlossls.c: one row of samples from its differences, the row
    above (None: the first row of an interval) and the predictor."""
    out = [0] * len(diff)
    if prev is None:
        ra = (diff[0] + (1 << (7 - pt))) & 0xFFFF
        out[0] = ra
        for x in range(1, len(diff)):
            ra = (diff[x] + ra) & 0xFFFF
            out[x] = ra
        return out
    rb = prev[0]
    ra = (diff[0] + rb) & 0xFFFF
    out[0] = ra
    for x in range(1, len(diff)):
        rc, rb = rb, prev[x]
        if psv == 1:
            p = ra
        elif psv == 2:
            p = rb
        elif psv == 3:
            p = rc
        elif psv == 4:
            p = ra + rb - rc
        elif psv == 5:
            p = ra + ((rb - rc) >> 1)
        elif psv == 6:
            p = rb + ((ra - rc) >> 1)
        else:
            p = (ra + rb) >> 1
        ra = (diff[x] + p) & 0xFFFF
        out[x] = ra
    return out


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


def _upsample(p, hr, vr, fancy=True):
    """A component plane [dh, dw] to the luma's grid, as jdsample.c does
    under do_fancy_upsampling: h2v1_fancy_upsample (3/4, 1/4 with biases
    1 and 2) and h2v2_fancy_upsample (9/16, 3/16, 3/16, 1/16 with biases 8
    and 7) where the plane is wider than 2 samples, h1v2_fancy_upsample
    (3/4, 1/4 with biases 1 and 2, vertically) at any width, else box
    upsampling (h2v1_upsample, h2v2_upsample, int_upsample), which is all
    a lossless frame gets (its 1-sample blocks turn fancy upsampling
    off). The edge samples stand in for the ones past the image, as
    libjpeg's context rows and edge cases make them."""
    p = p.astype(np.int64)
    if (hr, vr) == (1, 1):
        return p
    if not fancy:
        return p.repeat(vr, axis=0).repeat(hr, axis=1)
    if (hr, vr) == (1, 2):
        above, below = _edges(p, 0)
        return _interleave((3 * p + above + 1) >> 2, (3 * p + below + 2) >> 2,
                           0)
    if (hr, vr) not in ((2, 1), (2, 2)) or p.shape[1] <= 2:
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
    # arithmetic conditioning by table: (L, U) of DC, K of AC (jdmarker.c)
    cond = {t: [0, 1, 5] for t in range(16)}
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
        elif marker == 0xCC:                    # DAC
            for i in range(0, len(body) - 1, 2):
                tc, val = body[i], body[i + 1]
                if tc >= 32 or (tc < 16 and val & 15 > val >> 4):
                    raise ValueError(f"JPEG DAC marker: bad conditioning "
                                     f"{tc}: {val}")
                if tc < 16:
                    cond[tc][:2] = [val & 15, val >> 4]
                else:
                    cond[tc - 16][2] = val
        elif marker in _SOF:                    # SOF0-3, SOF9, SOF10
            p, h, w, nf = struct.unpack(">BHHB", body[:6])
            frame = _Frame(p, h, w, [tuple(body[6 + 3 * k:9 + 3 * k])
                                     for k in range(nf)], _SOF[marker])
        elif marker == 0xDA:                    # SOS
            if frame is None:
                raise ValueError("JPEG scan before its frame header")
            ns = body[0]
            comps = [tuple(body[1 + 2 * k:3 + 2 * k]) for k in range(ns)]
            scan = (comps, *body[1 + 2 * ns:4 + 2 * ns])
            segments, pos = _segments(data, pos)
            _decode_scan(frame, scan, (dc_tabs, ac_tabs, cond), restart,
                         segments)
    if frame is None:
        raise ValueError("JPEG stream has no frame header")
    return _to_rgba(frame, quant, jfif, adobe)


# jdcoefct.c:decompress_smooth_data: for zigzag terms 1-9, the natural
# position and the 5x5 kernels over the DC terms around a block (rows
# above to below, columns left to right) that estimate it: without any AC
# data of the first nine terms (DC interpolation, which also re-estimates
# the DC term) and with some
_SMOOTH_POS = (1, 8, 16, 9, 2, 3, 10, 17, 24)
_DC_KERNEL = ((-2, -6, -8, -6, -2), (-6, 6, 42, 6, -6),
              (-8, 42, 152, 42, -8), (-6, 6, 42, 6, -6),
              (-2, -6, -8, -6, -2))
_AC_KERNELS_DC = (
    ((-1, -1, 0, 1, 1), (-3, 13, 0, -13, 3), (-3, 38, 0, -38, 3),
     (-3, 13, 0, -13, 3), (-1, -1, 0, 1, 1)),
    ((-1, -3, -3, -3, -1), (-1, 13, 38, 13, -1), (0, 0, 0, 0, 0),
     (1, -13, -38, -13, 1), (1, 3, 3, 3, 1)),
    ((0, 0, 1, 0, 0), (0, 2, 7, 2, 0), (0, -5, -14, -5, 0),
     (0, 2, 7, 2, 0), (0, 0, 1, 0, 0)),
    ((-1, 0, 0, 0, 1), (0, 9, 0, -9, 0), (0, 0, 0, 0, 0),
     (0, -9, 0, 9, 0), (1, 0, 0, 0, -1)),
    ((0, 0, 0, 0, 0), (0, 2, -5, 2, 0), (1, 7, -14, 7, 1),
     (0, 2, -5, 2, 0), (0, 0, 0, 0, 0)),
    ((0, 0, 0, 0, 0), (0, 1, 0, -1, 0), (0, 2, 0, -2, 0),
     (0, 1, 0, -1, 0), (0, 0, 0, 0, 0)),
    ((0, 0, 0, 0, 0), (0, 1, -3, 1, 0), (0, 0, 0, 0, 0),
     (0, -1, 3, -1, 0), (0, 0, 0, 0, 0)),
    ((0, 0, 0, 0, 0), (0, 1, 0, -1, 0), (0, -3, 0, 3, 0),
     (0, 1, 0, -1, 0), (0, 0, 0, 0, 0)),
    ((0, 0, 0, 0, 0), (0, 1, 2, 1, 0), (0, 0, 0, 0, 0),
     (0, -1, -2, -1, 0), (0, 0, 0, 0, 0)))
_AC_KERNELS = (
    ((0, 0, 0, 0, 0), (0, 0, 0, 0, 0), (-7, 50, 0, -50, 7),
     (0, 0, 0, 0, 0), (0, 0, 0, 0, 0)),
    ((0, 0, -7, 0, 0), (0, 0, 50, 0, 0), (0, 0, 0, 0, 0),
     (0, 0, -50, 0, 0), (0, 0, 7, 0, 0)),
    ((0, 0, -1, 0, 0), (0, 0, 13, 0, 0), (0, 0, -24, 0, 0),
     (0, 0, 13, 0, 0), (0, 0, -1, 0, 0)),
    ((0, -1, 0, 1, 0), (-1, 10, 0, -10, 1), (0, 0, 0, 0, 0),
     (1, -10, 0, 10, -1), (0, 1, 0, -1, 0)),
    ((0, 0, 0, 0, 0), (0, 0, 0, 0, 0), (-1, 13, -24, 13, -1),
     (0, 0, 0, 0, 0), (0, 0, 0, 0, 0)))


def _smoothing_on(frame, quant) -> bool:
    """jdcoefct.c:smoothing_ok: a progressive frame whose components all
    have their DC terms at least in part and nonzero quantizers at the
    natural positions 0-9, and some component with one of its first
    nine AC terms unfinished."""
    if not frame.progressive:
        return False
    useful = False
    for c, bits in enumerate(frame.coef_bits):
        if (quant[frame.tq[c]][:10] == 0).any() or bits[0] < 0:
            return False
        useful |= any(b != 0 for b in bits[1:10])
    return useful


def _smooth_rows(frame, c):
    """The block rows whose DC terms decompress_smooth_data reads around
    each of component c's block rows (two above to two below): the edge
    row repeated where the row's place in the image says there is none.
    libjpeg-turbo 3.1.3 takes that place as iMCU row x block rows of the
    current iMCU row + block row, out of block rows x iMCU rows, which on
    a last iMCU row shorter than the others is not the row's own place;
    it is repeated here as it is."""
    v, last = frame.v[c], frame.mcuy - 1
    bh = -(-frame.dh[c] // 8)
    rows = []
    for r in range(frame.mcuy):
        n = v if r < last else (bh % v or v)
        for b in range(n):
            y, place = r * v + b, r * n + b
            p = y - 1 if place > 0 else y
            pp = y - 2 if place > 1 else p
            nx = y + 1 if place < n * frame.mcuy - 1 else y
            nn = y + 2 if place < n * frame.mcuy - 2 else nx
            rows.append((pp, p, y, nx, nn))
    return np.asarray(rows)


def _smooth(frame, c, coef, q):
    """decompress_smooth_data on component c's blocks [by, bx, 64]: each
    of the first nine AC terms that is still 0 and not known to its last
    bit estimated from the DC terms of the 5x5 blocks around (the edge
    blocks repeated), clamped below 1 << Al of its scan; with none of
    them coded, the DC term re-estimated too. Returns the smoothed
    real blocks [bh, bw, 64]."""
    bits = frame.coef_bits[c]
    bw = -(-frame.dw[c] // 8)
    rows = _smooth_rows(frame, c)
    cols = np.clip(np.arange(bw)[:, None] + np.arange(-2, 3), 0, bw - 1)
    dc = coef[..., 0][rows[:, None, :, None], cols[None, :, None, :]]
    out = coef[:len(rows), :bw].copy()
    change_dc = all(b == -1 for b in bits[1:10])
    kernels = _AC_KERNELS_DC if change_dc else _AC_KERNELS
    q00 = int(q[0])

    def estimate(kernel, qk):
        num = q00 * np.einsum("...ij,ij->...", dc, np.asarray(kernel))
        mag = ((qk << 7) + np.abs(num)) // (qk << 8)
        return num, mag

    for k, kernel in enumerate(kernels, start=1):
        al, pos = bits[k], _SMOOTH_POS[k - 1]
        if al == 0:
            continue
        num, mag = estimate(kernel, int(q[pos]))
        if al > 0:
            mag = np.minimum(mag, (1 << al) - 1)
        pred = np.where(num >= 0, mag, -mag)
        out[..., pos] = np.where(out[..., pos] == 0, pred, out[..., pos])
    if change_dc:
        num, mag = estimate(_DC_KERNEL, q00)
        out[..., 0] = np.where(num >= 0, mag, -mag)
    return out


def _to_rgba(frame, quant, jfif, adobe):
    if frame.lossless and len(frame.ids) > 1 and (jfif or adobe not in
                                                   (None, 0)):
        # libjpeg-turbo converts no colour in lossless mode, and without a
        # JFIF or Adobe marker reads lossless samples as RGB or CMYK
        raise ValueError("lossless JPEG in YCbCr or YCCK is not supported")
    smooth = _smoothing_on(frame, quant)
    planes = []
    for c in range(len(frame.ids)):
        if frame.lossless:
            s = frame.samples[c]
            if s is None:
                s = np.zeros((frame.dh[c], frame.dw[c]), np.int64)
        else:
            coef = frame.blocks(c)
            if smooth:
                coef = _smooth(frame, c, coef, quant[frame.tq[c]])
            by, bx = coef.shape[:2]
            s = _idct_islow(coef, quant[frame.tq[c]])  # [by, bx, 8, 8]
            s = s.transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)
            s = s[:frame.dh[c], :frame.dw[c]]
        up = _upsample(s, frame.hmax // frame.h[c], frame.vmax // frame.v[c],
                       not frame.lossless)
        planes.append(up[:frame.height, :frame.width])
    if len(planes) == 1:
        rgb = planes * 3
    elif len(planes) == 4:
        if adobe not in (None, 0):     # YCCK (jdcolor.c:ycck_cmyk_convert)
            planes = [255 - p for p in _ycc_to_rgb(*planes[:3])] \
                + planes[3:]
        rgb = _cmyk_to_rgb(planes)
    elif frame.lossless or not jfif and (
            adobe == 0 or (adobe is None and bytes(frame.ids) == b"RGB")):
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
