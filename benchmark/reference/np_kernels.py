"""Frozen copy, for the benchmark's plain reference, of
thor_tpu_torch/ops/np_kernels.py as of the benchmark's first version; it
imports nothing of the port, and the port's later changes do not reach
it.

Exact-integer pixel ops on the host (numpy), a copy of
thor_tpu/ops/np_kernels.py.

The transforms, the (de)quantizer's scaling, the reconstruction, luma and
chroma MC, the intra reference samples and the ten intra predictors, the
in-loop filters (deblocking, CLPF) and the reference edge padding. Each
mirrors the scalar semantics of the reference C (cited per function) with
exact integer arithmetic. The host mirror encoder uses the per-block ops
(its filters run on the encoder's device, enc/encoder.Encoder._filters);
the numpy decode backend (dec/reconstruct_np.py) uses them all.
"""

from __future__ import annotations

import numpy as np

from .constants import (
    FILTER_C, FILTER_Y_BI, FILTER_Y_CENTER, FILTER_Y_UNI, GDEQUANT_TABLE,
    log2i)
from .dct_tables import TMAT_4, TMAT_8, TMAT_16, TMAT_32, TMAT_64

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
    if LOW_PRECISION[0]:
        return _inverse_transform_bf16(coeff, M)
    c = coeff.astype(np.int32)
    tmp = M.T @ c                      # stage 1 over columns
    tmp = np.clip((tmp + 64) >> 7, -32768, 32767)
    out = M.T @ tmp.T                  # stage 2; note C transposes between
    out = np.clip((out + 2048) >> 12, -32768, 32767)
    return out.T.astype(np.int16)


# The benchmark's control (benchmark/control.py): set LOW_PRECISION[0] and
# both stages of the inverse transform run as bfloat16 products summed in
# float32 (a tensor-core GEMM's arithmetic), the step down from exact
# integer arithmetic that a faster decoder might take. It breaks the
# configuration's guarantee of a decode equal to Thordec's, so a
# comparison that is sound has to fail it.
LOW_PRECISION = [False]


def _bf16(a):
    """float32 values rounded to bfloat16 (8 significant bits, nearest
    even), kept as float32."""
    b = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def _inverse_transform_bf16(coeff, M):
    m = _bf16(M.T.astype(np.float32))
    tmp = m @ _bf16(coeff.astype(np.float32))
    tmp = np.clip(np.floor((tmp + 64) / 128), -32768, 32767)
    out = m @ _bf16(tmp.T)
    out = np.clip(np.floor((out + 2048) / 4096), -32768, 32767)
    return out.T.astype(np.int16)


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


# ---------------------------------------------------------------------------
# In-loop filters of the numpy decode backend (dec/reconstruct_np.py)
# ---------------------------------------------------------------------------

def deblock_frame_y(rec: np.ndarray, dd, width, height, qp,
                    beta_table, tc_table):
    """Luma deblocking (common/common_frame.c:46-241). In-place on rec."""
    beta = int(beta_table[qp])
    tc = int(tc_table[qp])
    MINB, MINP = 8, 4

    def do_edges(vertical: bool):
        if vertical:
            ii = range(0, height, MINB)
            jj = range(MINB, width, MINB)
        else:
            ii = range(MINB, height, MINB)
            jj = range(0, width, MINB)
        for ib in ii:
            for jb in jj:
                if vertical:
                    d = (abs(int(rec[ib + 2, jb - 2]) - int(rec[ib + 2, jb - 1]))
                         + abs(int(rec[ib + 2, jb + 1]) - int(rec[ib + 2, jb]))
                         + abs(int(rec[ib + 5, jb - 2]) - int(rec[ib + 5, jb - 1]))
                         + abs(int(rec[ib + 5, jb + 1]) - int(rec[ib + 5, jb])))
                else:
                    d = (abs(int(rec[ib - 2, jb + 2]) - int(rec[ib - 1, jb + 2]))
                         + abs(int(rec[ib + 1, jb + 2]) - int(rec[ib, jb + 2]))
                         + abs(int(rec[ib - 2, jb + 5]) - int(rec[ib - 1, jb + 5]))
                         + abs(int(rec[ib + 1, jb + 5]) - int(rec[ib, jb + 5])))
                for m in range(0, MINB, MINP):
                    if vertical:
                        qr, qc = (ib + m) // MINP, jb // MINP
                        pr, pc = qr, qc - 1
                    else:
                        qr, qc = ib // MINP, (jb + m) // MINP
                        pr, pc = qr - 1, qc
                    q_size = int(dd.size[qr, qc])
                    if vertical:
                        if ((dd.tb_split[qr, qc] or dd.pb_part[qr, qc] in (2, 3))
                                and q_size > MINB):
                            q_size //= 2
                    else:
                        if ((dd.tb_split[qr, qc] or dd.pb_part[qr, qc] in (1, 3))
                                and q_size > MINB):
                            q_size //= 2
                    mv = (abs(int(dd.mv0x[pr, pc])) >= 4 or abs(int(dd.mv0y[pr, pc])) >= 4
                          or abs(int(dd.mv0x[qr, qc])) >= 4 or abs(int(dd.mv0y[qr, qc])) >= 4
                          or abs(int(dd.mv1x[pr, pc])) >= 4 or abs(int(dd.mv1y[pr, pc])) >= 4
                          or abs(int(dd.mv1x[qr, qc])) >= 4 or abs(int(dd.mv1y[qr, qc])) >= 4)
                    cbp = dd.cbp_y[pr, pc] or dd.cbp_y[qr, qc]
                    mode = dd.mode[pr, pc] == 1 or dd.mode[qr, qc] == 1  # MODE_INTRA
                    pos = jb if vertical else ib
                    interior = (pos % q_size) > 0
                    if d < beta and not interior and (mv or cbp or mode):
                        for k in range(m, m + MINP):
                            if vertical:
                                y, x = ib + k, jb
                                p1, p0 = int(rec[y, x - 2]), int(rec[y, x - 1])
                                q0, q1 = int(rec[y, x]), int(rec[y, x + 1])
                            else:
                                y, x = ib, jb + k
                                p1, p0 = int(rec[y - 2, x]), int(rec[y - 1, x])
                                q0, q1 = int(rec[y, x]), int(rec[y + 1, x])
                            delta = (18 * (q0 - p0) - 6 * (q1 - p1) + 16) >> 5
                            delta = max(-tc, min(tc, delta))
                            dh = int(delta / 2) if delta >= 0 else -((-delta) // 2)
                            if vertical:
                                rec[y, x - 2] = min(255, max(0, p1 + dh))
                                rec[y, x - 1] = min(255, max(0, p0 + delta))
                                rec[y, x] = min(255, max(0, q0 - delta))
                                rec[y, x + 1] = min(255, max(0, q1 - dh))
                            else:
                                rec[y - 2, x] = min(255, max(0, p1 + dh))
                                rec[y - 1, x] = min(255, max(0, p0 + delta))
                                rec[y, x] = min(255, max(0, q0 - delta))
                                rec[y + 1, x] = min(255, max(0, q1 - dh))

    do_edges(True)
    do_edges(False)


def deblock_frame_uv(recu: np.ndarray, recv: np.ndarray, dd, width, height,
                     qpc, tc_table):
    """Chroma deblocking (common/common_frame.c:243-321). In-place."""
    tc = int(tc_table[qpc])
    MINB, MINP = 8, 4
    for recC in (recu, recv):
        # vertical
        for i in range(0, height, MINB):
            for j in range(MINB, width, MINB):
                qr, qc = i // MINP, j // MINP
                q_size = int(dd.size[qr, qc])
                mode = dd.mode[qr, qc - 1] == 1 or dd.mode[qr, qc] == 1
                interior = (j % q_size) > 0
                if mode and not interior:
                    i2, j2 = i // 2, j // 2
                    for k in range(MINB // 2):
                        p1, p0 = int(recC[i2 + k, j2 - 2]), int(recC[i2 + k, j2 - 1])
                        q0, q1 = int(recC[i2 + k, j2]), int(recC[i2 + k, j2 + 1])
                        delta = (4 * (q0 - p0) + (p1 - q1) + 4) >> 3
                        delta = max(-tc, min(tc, delta))
                        recC[i2 + k, j2 - 1] = min(255, max(0, p0 + delta))
                        recC[i2 + k, j2] = min(255, max(0, q0 - delta))
        # horizontal
        for i in range(MINB, height, MINB):
            for j in range(0, width, MINB):
                qr, qc = i // MINP, j // MINP
                q_size = int(dd.size[qr, qc])
                mode = dd.mode[qr - 1, qc] == 1 or dd.mode[qr, qc] == 1
                interior = (i % q_size) > 0
                if mode and not interior:
                    i2, j2 = i // 2, j // 2
                    for l in range(MINB // 2):
                        p1, p0 = int(recC[i2 - 2, j2 + l]), int(recC[i2 - 1, j2 + l])
                        q0, q1 = int(recC[i2, j2 + l]), int(recC[i2 + 1, j2 + l])
                        delta = (4 * (q0 - p0) + (p1 - q1) + 4) >> 3
                        delta = max(-tc, min(tc, delta))
                        recC[i2 - 1, j2 + l] = min(255, max(0, p0 + delta))
                        recC[i2, j2 + l] = min(255, max(0, q0 - delta))


def clpf_block(src: np.ndarray, x0: int, y0: int, size: int, dstride: int,
               width: int, height: int) -> np.ndarray:
    """Constrained low-pass filter for one block
    (common/common_block.c:180-197). Returns the filtered (size,size) tile.

    src: full plane; boundary neighbors clamp at the dstride-aligned block.
    """
    left = x0 & ~(dstride - 1)
    top = y0 & ~(dstride - 1)
    right = min(width - 1, left + dstride - 1)
    bottom = min(height - 1, top + dstride - 1)

    X = src[y0:y0 + size, x0:x0 + size].astype(np.int32)
    ys = np.arange(y0, y0 + size)[:, None]
    xs = np.arange(x0, x0 + size)[None, :]
    A = np.where(ys == top, X, src[np.maximum(ys - 1, 0), xs].astype(np.int32))
    B = np.where(xs == left, X, src[ys, np.maximum(xs - 1, 0)].astype(np.int32))
    C = np.where(xs == right, X, src[ys, np.minimum(xs + 1, width - 1)].astype(np.int32))
    D = np.where(ys == bottom, X, src[np.minimum(ys + 1, height - 1), xs].astype(np.int32))
    delta = (((A > X).astype(np.int32) + (B > X) + (C > X) + (D > X)) > 2).astype(np.int32) \
        - (((A < X).astype(np.int32) + (B < X) + (C < X) + (D < X)) > 2).astype(np.int32)
    return (X + delta).astype(np.uint8)


def clpf_plane_dense(P: np.ndarray, sbs: int, width: int,
                     height: int) -> np.ndarray:
    """Whole-plane CLPF (vectorized clpf_block,
    common/common_block.c:180-197): every pixel filtered with
    neighbour clamping at its sbs-aligned block boundary. The caller
    selects which blocks actually take the filtered value."""
    X = P.astype(np.int32)
    ys = np.arange(height)[:, None]
    xs = np.arange(width)[None, :]
    up = np.vstack([P[0:1], P[:-1]]).astype(np.int32)
    down = np.vstack([P[1:], P[-1:]]).astype(np.int32)
    left = np.hstack([P[:, 0:1], P[:, :-1]]).astype(np.int32)
    right = np.hstack([P[:, 1:], P[:, -1:]]).astype(np.int32)
    A = np.where(ys % sbs == 0, X, up)
    B = np.where(xs % sbs == 0, X, left)
    C = np.where((xs % sbs == sbs - 1) | (xs == width - 1), X, right)
    D = np.where((ys % sbs == sbs - 1) | (ys == height - 1), X, down)
    delta = (((A > X).astype(np.int32) + (B > X) + (C > X)
              + (D > X)) > 2).astype(np.int32) \
        - (((A < X).astype(np.int32) + (B < X) + (C < X)
            + (D < X)) > 2).astype(np.int32)
    return (X + delta).astype(np.uint8)


def pad_plane(plane: np.ndarray, pad: int) -> np.ndarray:
    """Edge-replication padding (common/common_frame.c:405-462)."""
    return np.pad(plane, pad, mode="edge")
