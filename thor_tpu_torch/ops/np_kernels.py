"""Exact-integer pixel ops of the host mirror encoder (numpy).

Counterpart of the per-block part of thor_tpu/ops/np_kernels.py: the
transforms, the (de)quantizer's scaling, the reconstruction, luma and
chroma MC, the intra reference samples and the ten intra predictors,
and the reference edge padding. Each mirrors the scalar semantics of the
reference C (cited per function) with exact integer arithmetic. The
mirror's in-loop filters run on the encoder's device instead
(enc/encoder.Encoder._filters, the decoder's deblocking and CLPF ops).
"""

from __future__ import annotations

import numpy as np

from ..codec.constants import (
    FILTER_C, FILTER_Y_BI, FILTER_Y_CENTER, FILTER_Y_UNI, GDEQUANT_TABLE,
    MAX_QUANT_SIZE, log2i)
from ..codec.dct_tables import TMAT_4, TMAT_8, TMAT_16, TMAT_32, TMAT_64

TMAT = {4: np.array(TMAT_4, np.int32), 8: np.array(TMAT_8, np.int32),
        16: np.array(TMAT_16, np.int32), 32: np.array(TMAT_32, np.int32),
        64: np.array(TMAT_64, np.int32)}


def clip255(x):
    return np.clip(x, 0, 255)


def dequantize(coeff: np.ndarray, qp: int) -> np.ndarray:
    """common/common_block.c:132-146. coeff: (size,size) int; -> int16."""
    size = coeff.shape[-1]
    lshift = qp // 6
    rshift = log2i(size) - 1
    scale = int(GDEQUANT_TABLE[qp % 6])
    add = 1 << (rshift - 1)
    v = ((coeff.astype(np.int64) * scale) << lshift) + add
    return (v >> rshift).astype(np.int16)


def inverse_transform(coeff: np.ndarray, size: int) -> np.ndarray:
    """common/transform.c:432-518. coeff: (size,size) int16 -> (size,size) int16.

    The reference's partial-butterfly factorization for size>=16 is
    integer-equal to the plain truncated matmul (only the first 16
    coefficient rows are nonzero), so both stages are M^T @ X matmuls.
    """
    if size == 64:
        # 32x32 inverse of low quadrant + 2x2 pixel replication
        # (common/transform.c:488-518)
        sub = inverse_transform(np.ascontiguousarray(coeff[:32, :32]), 32)
        return np.repeat(np.repeat(sub, 2, axis=0), 2, axis=1)
    M = TMAT[size]
    c = coeff.astype(np.int32)
    tmp = M.T @ c                      # stage 1 over columns
    tmp = np.clip((tmp + 64) >> 7, -32768, 32767)
    out = M.T @ tmp.T                  # stage 2; note C transposes between
    out = np.clip((out + 2048) >> 12, -32768, 32767)
    return out.T.astype(np.int16)


def transform_fwd(block: np.ndarray, size: int, fast: bool) -> np.ndarray:
    """Forward transform (common/transform.c:249-330).

    block: (size,size) int16 residual. Returns (size,size) int16 with only
    the top-left min(size,16)^2 coefficients nonzero.
    """
    dsize = size
    qsize = min(size, MAX_QUANT_SIZE)
    tr_log2size = log2i(size)
    shift_1 = tr_log2size + 8 - 8
    shift_2 = tr_log2size + 5
    inb = block.astype(np.int32)

    if size > 16 and fast:
        shift_1 += 1 + (1 if size == 64 else 0)
        shift_2 = 9
        f = size // 16
        inb = inb.reshape(16, f, 16, f).sum(axis=(1, 3))
        size = 16
    elif size == 64:
        shift_1, shift_2 = 7, 10
        inb = inb.reshape(32, 2, 32, 2).sum(axis=(1, 3))
        size = 32

    M = TMAT[size]
    add_1, add_2 = 1 << (shift_1 - 1), 1 << (shift_2 - 1)
    # tmp[i][j] = (sum_k M[i,k]*in[j,k] + add1) >> shift1, int16 wraparound
    tmp = ((M[:qsize] @ inb.T + add_1) >> shift_1).astype(np.int16)
    # coeff[i][j] = (sum_k M[i,k]*tmp[j,k] + add2) >> shift2
    coeff = ((M[:qsize] @ tmp.T.astype(np.int32) + add_2) >> shift_2).astype(np.int16)
    out = np.zeros((dsize, dsize), np.int16)
    out[:qsize, :qsize] = coeff
    return out


def reconstruct_block(resid: np.ndarray, pred: np.ndarray) -> np.ndarray:
    """common/common_block.c:148-156. int16 + uint8 -> uint8 clipped."""
    return clip255(resid.astype(np.int32) + pred.astype(np.int32)).astype(np.uint8)


# ---------------------------------------------------------------------------
# Inter prediction (motion compensation)
# ---------------------------------------------------------------------------

def mc_luma(ref: np.ndarray, oy: int, ox: int, height: int, width: int,
            mvx: int, mvy: int, sign: int, bipred: int) -> np.ndarray:
    """1/4-pel 6-tap luma MC (common/inter_prediction.c:120-180).

    ref: padded reference plane (2D uint8); (oy, ox) is the block origin
    in ref's index space (padding offset already applied).
    """
    if sign:
        mvx, mvy = -mvx, -mvy
    ver_frac, hor_frac = mvy & 3, mvx & 3
    ver_int, hor_int = mvy >> 2, mvx >> 2
    y0, x0 = oy + ver_int, ox + hor_int

    if ver_frac == 0 and hor_frac == 0:
        return ref[y0:y0 + height, x0:x0 + width].copy()

    if ver_frac == 2 and hor_frac == 2:
        # funny position: 4x4 low-pass, offsets -1..+2
        win = ref[y0 - 1:y0 + height + 3, x0 - 1:x0 + width + 3].astype(np.int32)
        s = np.zeros((height, width), np.int32)
        for m in range(4):
            for n in range(4):
                w = int(FILTER_Y_CENTER[m, n])
                if w:
                    s += w * win[m:m + height, n:n + width]
        return clip255((s + 8) >> 4).astype(np.uint8)

    fv = (FILTER_Y_BI if bipred else FILTER_Y_UNI)[ver_frac]
    fh = (FILTER_Y_BI if bipred else FILTER_Y_UNI)[hor_frac]
    # window: rows y0-2 .. y0+height+3, cols x0-2 .. x0+width+3
    win = ref[y0 - 2:y0 + height + 3, x0 - 2:x0 + width + 3].astype(np.int32)
    # vertical 6-tap over rows
    tmp = np.zeros((height, width + 5), np.int32)
    for m in range(6):
        w = int(fv[m])
        if w:
            tmp += w * win[m:m + height, :]
    # horizontal 6-tap over cols
    out = np.zeros((height, width), np.int32)
    for m in range(6):
        w = int(fh[m])
        if w:
            out += w * tmp[:, m:m + width]
    return clip255((out + 2048) >> 12).astype(np.uint8)


def mc_chroma(ref: np.ndarray, oy: int, ox: int, height: int, width: int,
              mvx: int, mvy: int, sign: int) -> np.ndarray:
    """1/8-pel 4-tap chroma MC (common/inter_prediction.c:72-118)."""
    if sign:
        mvx, mvy = -mvx, -mvy
    ver_frac, hor_frac = mvy & 7, mvx & 7
    ver_int, hor_int = mvy >> 3, mvx >> 3
    y0, x0 = oy + ver_int, ox + hor_int

    if ver_frac == 0 and hor_frac == 0:
        return ref[y0:y0 + height, x0:x0 + width].copy()

    fh = FILTER_C[hor_frac]
    fv = FILTER_C[ver_frac]
    # horizontal first (rows y0-1 .. y0+height+2), taps at col offsets -1..2
    win = ref[y0 - 1:y0 + height + 2, x0 - 1:x0 + width + 3].astype(np.int32)
    tmp = np.zeros((height + 3, width), np.int32)
    for m in range(4):
        w = int(fh[m])
        if w:
            tmp += w * win[:, m:m + width]
    out = np.zeros((height, width), np.int32)
    for m in range(4):
        w = int(fv[m])
        if w:
            out += w * tmp[m:m + height, :]
    return clip255((out + 2048) >> 12).astype(np.uint8)


# ---------------------------------------------------------------------------
# Intra prediction
# ---------------------------------------------------------------------------

def make_top_and_left(frame: np.ndarray, ty: int, tx: int, cb_xpos: int,
                      size: int, upright_av: bool, downleft_av: bool):
    """Reference samples of an intra block (common/intra_prediction.c:57-143).

    frame: reconstructed plane (2D uint8, unpadded index space).
    (ty, tx): absolute TU position; cb_xpos: the CB x (the reference's
    top-left rule tests CB xpos, not TU xpos). Returns (left[2s], top[2s],
    top_left) as int arrays / int.
    """
    L = 2 * size
    top = np.empty(L, np.uint8)
    left = np.empty(L, np.uint8)
    toplen = size + 1 if upright_av else size
    leftlen = size + 1 if downleft_av else size

    if ty == 0:
        top[:] = 128
        top_left = 128
    else:
        row = frame[ty - 1, tx:tx + toplen]
        top[:toplen] = row
        top[size:] = top[toplen - 1]
        top_left = int(frame[ty - 1, tx - 1]) if cb_xpos > 0 else int(top[0])

    if tx == 0:
        left[:] = 128
    else:
        col = frame[ty:ty + leftlen, tx - 1]
        left[:leftlen] = col
        left[size:] = left[leftlen - 1]

    if ty == 0:
        top_left = int(left[0])
    return left, top, top_left


def _filter_121(a: np.ndarray) -> np.ndarray:
    """common/intra_prediction.c:39-48 (uint8 in/out)."""
    x = a.astype(np.int32)
    prev = np.concatenate(([x[0]], x[:-1]))
    nxt = np.concatenate((x[1:], [x[-1]]))
    return ((prev + 2 * x + nxt + 2) >> 2).astype(np.uint8)


def intra_prediction(left: np.ndarray, top: np.ndarray, top_left: int,
                     ypos: int, xpos: int, size: int, mode: int) -> np.ndarray:
    """10-mode intra prediction (common/intra_prediction.c:145-388)."""
    i = np.arange(size)[:, None]
    j = np.arange(size)[None, :]

    if mode == 0 or mode >= 10:  # DC
        l = left if xpos != 0 else top
        t = top if ypos != 0 else left
        s = int(t[:size].astype(np.int32).sum() + l[:size].astype(np.int32).sum())
        dc = (s + size) // (2 * size)
        return np.full((size, size), dc, np.uint8)
    if mode == 2:  # HOR
        return np.broadcast_to(left[:size, None], (size, size)).astype(np.uint8)
    if mode == 3:  # VER
        return np.broadcast_to(top[None, :size], (size, size)).astype(np.uint8)
    if mode == 1:  # PLANAR (5-tap filtered edges, trunc-div by 8)
        t = top.astype(np.int32)
        l = left.astype(np.int32)

        def filt5(v):
            f = np.empty(size, np.int32)
            f[0] = v[0] + 2 * v[0] + 2 * v[0] + 2 * v[1] + v[2]
            f[1] = v[0] + 2 * v[0] + 2 * v[1] + 2 * v[2] + v[3]
            for k in range(2, size - 2):
                f[k] = v[k - 2] + 2 * v[k - 1] + 2 * v[k] + 2 * v[k + 1] + v[k + 2]
            f[size - 2] = v[size - 4] + 2 * v[size - 3] + 2 * v[size - 2] + 2 * v[size - 1] + v[size - 1]
            f[size - 1] = v[size - 3] + 2 * v[size - 2] + 2 * v[size - 1] + 2 * v[size - 1] + v[size - 1]
            return f

        topF, leftF = filt5(t), filt5(l)
        tlF = int(l[1] + 2 * l[0] + 2 * top_left + 2 * t[0] + t[1])
        v = leftF[:, None] + topF[None, :] - tlF + 4
        q = np.where(v >= 0, v // 8, -((-v) // 8))  # C trunc division
        return clip255(q).astype(np.uint8)

    # Diagonal modes use 121-filtered edges
    if mode == 5:  # UPRIGHT
        topF = _filter_121(top).astype(np.int32)
        return topF[i + j + 1].astype(np.uint8)
    if mode == 9:  # DOWNLEFTLEFT
        leftF = _filter_121(left).astype(np.int32)
        diag = 2 * i + j
        odd = (diag & 1) == 1
        a = leftF[(diag + 1) // 2]
        b = (leftF[diag // 2] + leftF[np.minimum(diag // 2 + 1, 2 * size - 1)]) >> 1
        return np.where(odd, a, b).astype(np.uint8)

    leftF = _filter_121(left[:size]).astype(np.int32)
    topF = _filter_121(top[:size]).astype(np.int32)
    tlF = (2 * int(top_left) + int(left[0]) + int(top[0]) + 2) >> 2

    if mode == 4:  # UPLEFT
        diag = i - j
        out = np.where(diag > 0, leftF[np.abs(diag) - 1],
                       np.where(diag == 0, tlF, topF[np.abs(diag) - 1]))
        return out.astype(np.uint8)
    if mode == 7:  # UPUPLEFT
        diag = i - 2 * j
        nd = np.abs(np.minimum(diag, 0))
        a_left = leftF[np.maximum(diag - 2, 0)]
        a_odd = topF[np.minimum(nd // 2, size - 1)]
        a_even = (topF[np.minimum(nd // 2, size - 1)]
                  + topF[np.maximum(nd // 2 - 1, 0)]) >> 1
        out = np.where(diag > 1, a_left,
                       np.where(diag == 1, tlF,
                                np.where(diag == 0, (tlF + topF[0]) >> 1,
                                         np.where((nd & 1) == 1, a_odd, a_even))))
        return out.astype(np.uint8)
    if mode == 8:  # UPLEFTLEFT
        diag = 2 * i - j
        pd = np.maximum(diag, 0)
        a_top = topF[np.maximum(-diag - 2, 0)]
        a_odd = leftF[np.minimum(pd // 2, size - 1)]
        a_even = (leftF[np.minimum(pd // 2, size - 1)]
                  + leftF[np.maximum(pd // 2 - 1, 0)]) >> 1
        out = np.where(diag < -1, a_top,
                       np.where(diag == -1, tlF,
                                np.where(diag == 0, (tlF + leftF[0]) >> 1,
                                         np.where((pd & 1) == 1, a_odd, a_even))))
        return out.astype(np.uint8)
    if mode == 6:  # UPUPRIGHT
        topF2 = _filter_121(top).astype(np.int32)
        diag = i + 2 * j
        odd = (diag & 1) == 1
        a = topF2[(diag + 1) // 2]
        b = (topF2[diag // 2] + topF2[diag // 2 + 1]) >> 1
        return np.where(odd, a, b).astype(np.uint8)
    raise ValueError(f"bad intra mode {mode}")


def pad_plane(plane: np.ndarray, pad: int) -> np.ndarray:
    """Edge-replication padding (common/common_frame.c:405-462)."""
    return np.pad(plane, pad, mode="edge")
