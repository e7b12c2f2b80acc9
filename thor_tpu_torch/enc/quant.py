"""Forward quantization with "RDOQ light" (enc/encode_block.c:75-172)
for the host mirror encoder.

Counterpart of thor_tpu/enc/quant.py. Zigzag, last-pos search and the
forward quant are numpy array expressions; the pattern-based
single-coefficient rescue loop is sequential but short. The full trellis
RDOQ (rdoq=1, enc/encode_block.c:179-472) is _rdoq below.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..bitstream.writer import quote_vlc
from ..codec.constants import (
    GQUANT_TABLE, GDEQUANT_TABLE, MAX_QUANT_SIZE, SQUARED_LAMBDA_QP,
    zigzag_for, log2i)
from .syntax import find_code


def quantize(coeff: np.ndarray, qp: int, size: int, coeff_block_type: int,
             rdoq: int):
    """Returns (cbp, coeffq) where coeffq is (size, size) int16 with the
    quantized qsize x qsize block at the top-left.

    Mirrors enc/encode_block.c:75-172 exactly (offsets 38/-26 for
    last-pos, 102/51 & 115/90 for levels, scaled by 256 of the step).
    """
    intra_block = (coeff_block_type >> 1) & 1
    chroma_flag = coeff_block_type & 1
    tr_log2size = log2i(size)
    qsize = min(MAX_QUANT_SIZE, size)
    scale = int(GQUANT_TABLE[qp % 6])
    shift2 = 21 - tr_log2size + qp // 6
    N = qsize * qsize

    zz = zigzag_for(qsize)
    scoeff = np.zeros(N, np.int64)
    scoeff[zz] = coeff[:qsize, :qsize].reshape(-1).astype(np.int64)

    # last_pos scan (intra/inter offsets 38/-26, scaled by 256)
    offset = (38 if intra_block else -26) << (shift2 - 8)
    levels = np.abs(np.abs(scoeff) * scale + offset) >> shift2
    nz = np.nonzero(levels)[0]
    if len(nz) == 0:
        # replicate the C scan result: last_pos = -1 means nothing coded
        return 0, np.zeros((size, size), np.int16)
    last_pos = int(nz[-1])

    # forward quant up to last_pos
    offset0 = (102 if intra_block else 51) << (shift2 - 8)
    offset1 = (115 if intra_block else 90) << (shift2 - 8)
    sc = scoeff[:last_pos + 1]
    sign = np.where(sc < 0, -1, 1)
    abs_coeff = scale * np.abs(sc)
    level0 = abs_coeff >> shift2
    off = np.where((level0 == 0) | bool(chroma_flag), offset0, offset1)
    level = (abs_coeff + off) >> shift2
    scoeffq = np.zeros(N, np.int64)
    scoeffq[:last_pos + 1] = sign * level
    cbp = int((level != 0).any())

    # RDOQ light (enc/encode_block.c:134-168). A step rewrites only
    # positions at or before its own, so it reads its own level as the
    # forward quant left it: only the positions whose level exceeds 1 can
    # act, and the loop visits those alone, in order, on Python ints.
    if cbp:
        Nn = last_pos + 1 if chroma_flag else N
        threshold = (73 * int(GDEQUANT_TABLE[qp % 6]) << (qp // 6)) \
            >> (4 + tr_log2size)
        q = scoeffq.tolist()
        c = scoeff.tolist()
        for pos in (np.nonzero(np.abs(scoeffq[2:Nn]) > 1)[0] + 2).tolist():
            flag = 1
            if pos > 2 and abs(q[pos - 3]) > 1:
                flag = 0
            if pos > 3 and abs(q[pos - 4]) > 1 and abs(q[pos - 3]) > 0:
                flag = 0
            if pos == 2 and (chroma_flag == 0 or last_pos >= 6):
                flag = 0
            if flag and q[pos - 2] == 0 and q[pos - 1] == 0:
                K1 = abs(c[pos])
                K2 = abs(c[pos - 1])
                K3 = abs(c[pos - 2])
                K4 = max(K2, K3)
                if K1 + K4 < threshold:
                    q[pos] = -1 if c[pos] < 0 else 1
                else:
                    if K2 > K3:
                        q[pos - 1] = -1 if c[pos - 1] < 0 else 1
                    else:
                        q[pos - 2] = -1 if c[pos - 2] < 0 else 1
        scoeffq = np.array(q, np.int64)

    if rdoq and cbp:
        cbp = _rdoq(scoeff, scoeffq, qp, tr_log2size, qsize, chroma_flag,
                    size, last_pos)

    out = np.zeros((size, size), np.int16)
    out[:qsize, :qsize] = scoeffq[zz].reshape(qsize, qsize)
    return cbp, out


def _eob_bits(level, pos, N, chroma_flag, size):
    """EOB bit-usage model used at each truncation point
    (enc/encode_block.c:228-262)."""
    bit = 0
    if pos < N - 1:
        if level > 1:
            tmp_vlc = 1 if (level > 3 and chroma_flag == 0) else 0
            bit += quote_vlc(tmp_vlc, 0)
            if pos < N - 2:
                bit += _eob_code_bits(chroma_flag, size)
        else:
            bit += _eob_code_bits(chroma_flag, size)
    return bit


@lru_cache(maxsize=None)
def _eob_code_bits(chroma_flag, size):
    cn = find_code(0, 0, 0, chroma_flag, 1)
    if chroma_flag and size <= 8:
        return quote_vlc(0, cn)
    if cn == 0:
        return 2
    return quote_vlc(2, cn + 1)


def _rdoq(scoeff, scoeffq, qp, tr_log2size, qsize, chroma_flag, size,
          last_pos):
    """Full RDOQ: replicate the exact VLC bit costs along the forward
    scan and choose the best truncation point min_pos, with cbp=0 and
    the chroma-DC special case (enc/encode_block.c:179-472, quirks
    mirrored: the DC case dequantizes `sign` itself and stores it)."""
    N = qsize * qsize
    lshift = qp // 6
    rshift = tr_log2size - 1
    scale_dec = int(GDEQUANT_TABLE[qp % 6])
    add_dec = 1 << (rshift - 1)
    lam = 1.0 * SQUARED_LAMBDA_QP[qp] * float(1 << (2 * (7 - tr_log2size)))

    min_pos = 0
    cost0 = 0
    min_cost = (1 << 32) - 1
    tail_sq = np.concatenate([
        np.cumsum((scoeff * scoeff)[::-1])[::-1][1:], [0]]).astype(
            np.int64).tolist()
    q = scoeffq.tolist()
    so = scoeff.tolist()

    level_mode = 1
    level = 1
    pos = 0
    vlc_adaptive = 0
    while pos <= last_pos:
        if level_mode:
            vlc_adaptive = 1 if (level > 3 and chroma_flag == 0) else 0
            while pos <= last_pos and level > 0:
                c = q[pos]
                level = abs(c)
                bit = quote_vlc(vlc_adaptive, level)
                if level > 0:
                    bit += 1
                if chroma_flag == 0:
                    vlc_adaptive = 1 if level > 3 else 0
                org = so[pos]
                rec = ((c * scale_dec << lshift) + add_dec) >> rshift
                err = (rec - org) * (rec - org)
                if chroma_flag == 1 and pos == 0 and level == 1:
                    bit = 1
                cost0 += err + int(lam * bit + 0.5)
                cost1 = cost0 + tail_sq[pos]
                bit = _eob_bits(level, pos, N, chroma_flag, size)
                cost1 += int(lam * bit + 0.5)
                if cost1 < min_cost:
                    min_cost = cost1
                    min_pos = pos
                pos += 1
        maxrun = N - pos - 1
        run = 0
        c = 0
        while c == 0 and pos <= last_pos:
            c = q[pos]
            if c == 0:
                run += 1
                org = so[pos]
                cost0 += org * org
            else:
                level = abs(c)
                sign = 1 if c < 0 else 0
                cn = find_code(run, level, maxrun, chroma_flag, 0)
                bit = 0
                if chroma_flag and size <= 8:
                    bit += quote_vlc(10, cn)
                else:
                    bit += 2 if cn == 0 else quote_vlc(2, cn + 1)
                if level > 1:
                    bit += quote_vlc(0, 2 * (level - 2) + sign)
                else:
                    bit += 1
                run = 0
                org = so[pos]
                rec = ((c * scale_dec << lshift) + add_dec) >> rshift
                err = (rec - org) * (rec - org)
                cost0 += err + int(lam * bit + 0.5)
                cost1 = cost0 + tail_sq[pos]
                bit = _eob_bits(level, pos, N, chroma_flag, size)
                cost1 += int(lam * bit + 0.5)
                if cost1 < min_cost:
                    min_cost = cost1
                    min_pos = pos
            pos += 1
            vlc_adaptive = 1 if (level > 3 and chroma_flag == 0) else 0
            level_mode = 1 if level > 1 else 0

    # Evaluate cbp = 0
    cost1 = int((scoeff * scoeff).sum())
    if cost1 < min_cost:
        min_pos = -1
        min_cost = cost1
    if chroma_flag:
        # Special DC case (reference stores `sign` itself, 0 or 1)
        sign = 1 if scoeff[0] < 0 else 0
        rec = ((sign * scale_dec << lshift) + add_dec) >> rshift
        err = (int(scoeff[0]) - rec) * (int(scoeff[0]) - rec)
        cost1 = err + int(lam * 1 + 0.5) + tail_sq[0]
        if cost1 < min_cost:
            min_pos = 0
            scoeffq[0] = sign
    scoeffq[min_pos + 1:] = 0
    return int((scoeffq != 0).any())
