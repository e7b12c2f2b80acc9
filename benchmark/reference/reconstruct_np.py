"""Frozen copy, for the benchmark's plain reference, of
thor_tpu_torch/dec/reconstruct_np.py as of the benchmark's first
version; it imports nothing of the port, and the port's later changes do
not reach it.

The numpy decode backend: frame reconstruction from parsed syntax on
the host, a copy of thor_tpu/dec/reconstruct_np.py.

Consumes FrameSyntax records (from either parser) and padded host
reference frames and reconstructs each frame exactly as
dec/decode_block.c + dec/decode_frame.c do: per-block prediction,
residual (dequant + inverse transform) and reconstruction, then the
frame's deblocking; CLPF follows in apply_clpf. It is the exact host
oracle of the device route (dec/reconstruct.py) and runs no kernel.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .blockdata import get_downleft_available, get_upright_available
from .constants import (
    BETA_TABLE, CHROMA_QP, MODE_BIPRED, MODE_INTER, MODE_INTRA, MODE_MERGE,
    MODE_SKIP, PAD_C, PAD_Y, TC_TABLE)
from . import np_kernels as K
from .parse import BlockRec, FrameSyntax


class RefFrame:
    """Padded reference frame (create_yuv_frame + pad, PADDING_Y=96)."""

    PAD_Y = PAD_Y
    PAD_C = PAD_C

    def __init__(self, y, u, v, frame_num):
        self.frame_num = frame_num
        self.y = K.pad_plane(y, self.PAD_Y)
        self.u = K.pad_plane(u, self.PAD_C)
        self.v = K.pad_plane(v, self.PAD_C)


def _residual(coeff: np.ndarray, size: int, qp: int, tb_split: bool) -> np.ndarray:
    """Dequant + inverse transform, with TU split handling
    (dec/decode_block.c:90-120)."""
    if tb_split:
        s2 = size // 2
        out = np.empty((size, size), np.int16)
        for i in (0, 1):
            for j in (0, 1):
                sub = np.ascontiguousarray(
                    coeff[i * s2:(i + 1) * s2, j * s2:(j + 1) * s2])
                rc = K.dequantize(sub, qp)
                out[i * s2:(i + 1) * s2, j * s2:(j + 1) * s2] = \
                    K.inverse_transform(rc, s2)
        return out
    return K.inverse_transform(K.dequantize(coeff, qp), size)


def _intra_reconstruct(plane, b: BlockRec, oy, ox, size, qp, coeff,
                       tb_split, upright_av, downleft_av, cb_xpos):
    """decode_and_reconstruct_block_intra (dec/decode_block.c:48-88)."""
    if tb_split:
        s2 = size // 2
        for i in (0, s2):
            for j in (0, s2):
                up_av = (j == 0) or (i == 0 and upright_av)
                dl_av = (j == 0) and (i == 0 or downleft_av)
                left, top, tl = K.make_top_and_left(
                    plane, oy + i, ox + j, cb_xpos, s2, up_av, dl_av)
                pred = K.intra_prediction(left, top, tl, oy + i, ox + j, s2,
                                          b.intra_mode)
                sub = np.ascontiguousarray(coeff[i:i + s2, j:j + s2])
                resid = K.inverse_transform(K.dequantize(sub, qp), s2)
                plane[oy + i:oy + i + s2, ox + j:ox + j + s2] = \
                    K.reconstruct_block(resid, pred)
    else:
        left, top, tl = K.make_top_and_left(
            plane, oy, ox, cb_xpos, size, upright_av, downleft_av)
        pred = K.intra_prediction(left, top, tl, oy, ox, size, b.intra_mode)
        resid = K.inverse_transform(K.dequantize(coeff, qp), size)
        plane[oy:oy + size, ox:ox + size] = K.reconstruct_block(resid, pred)


def reconstruct_frame(fs: FrameSyntax, refs: List[RefFrame], interp_frame,
                      width: int, height: int, seq_bipred: int,
                      deblocking: int):
    """Returns (y, u, v) uint8 planes for the frame (pre-CLPF if any)."""
    y = np.zeros((height, width), np.uint8)
    u = np.zeros((height // 2, width // 2), np.uint8)
    v = np.zeros((height // 2, width // 2), np.uint8)
    qp = fs.qp
    cur_num = fs.display_frame_num

    def ref_for(ref_idx):
        r = fs.ref_array[ref_idx]
        return refs[r] if r >= 0 else interp_frame

    PY, PC = RefFrame.PAD_Y, RefFrame.PAD_C

    for b in fs.blocks:
        oy, ox = b.ypos, b.xpos
        size, sizeC = b.size, b.size // 2
        oyC, oxC = oy // 2, ox // 2
        qpY = b.qp
        qpC = int(CHROMA_QP[qpY])

        if b.mode == MODE_INTRA:
            up_av = get_upright_available(oy, ox, size, width)
            dl_av = get_downleft_available(oy, ox, size, height)
            _intra_reconstruct(y, b, oy, ox, size, qpY, b.coeff_y,
                               b.tb_split, up_av, dl_av, ox)
            tbc = b.tb_split and size > 8
            _intra_reconstruct(u, b, oyC, oxC, sizeC, qpC, b.coeff_u,
                               tbc, up_av, dl_av, oxC)
            _intra_reconstruct(v, b, oyC, oxC, sizeC, qpC, b.coeff_v,
                               tbc, up_av, dl_av, oxC)
            continue

        bw, bh = b.bwidth, b.bheight
        if b.mode == MODE_SKIP:
            if b.dir == 2:
                r0, r1 = ref_for(b.ref_idx0), ref_for(b.ref_idx1)
                s0 = 1 if r0.frame_num >= cur_num else 0
                s1 = 1 if r1.frame_num >= cur_num else 0
                mv0, mv1 = b.mv_arr0[0], b.mv_arr1[0]
                py0 = K.mc_luma(r0.y, PY + oy, PY + ox, bh, bw, mv0[0], mv0[1], s0, seq_bipred)
                py1 = K.mc_luma(r1.y, PY + oy, PY + ox, bh, bw, mv1[0], mv1[1], s1, seq_bipred)
                pu0 = K.mc_chroma(r0.u, PC + oyC, PC + oxC, bh // 2, bw // 2, mv0[0], mv0[1], s0)
                pu1 = K.mc_chroma(r1.u, PC + oyC, PC + oxC, bh // 2, bw // 2, mv1[0], mv1[1], s1)
                pv0 = K.mc_chroma(r0.v, PC + oyC, PC + oxC, bh // 2, bw // 2, mv0[0], mv0[1], s0)
                pv1 = K.mc_chroma(r1.v, PC + oyC, PC + oxC, bh // 2, bw // 2, mv1[0], mv1[1], s1)
                y[oy:oy + bh, ox:ox + bw] = ((py0.astype(np.int32) + py1) >> 1).astype(np.uint8)
                u[oyC:oyC + bh // 2, oxC:oxC + bw // 2] = ((pu0.astype(np.int32) + pu1) >> 1).astype(np.uint8)
                v[oyC:oyC + bh // 2, oxC:oxC + bw // 2] = ((pv0.astype(np.int32) + pv1) >> 1).astype(np.uint8)
            else:
                r = ref_for(b.ref_idx0)
                sign = 1 if r.frame_num > cur_num else 0
                mv = b.mv_arr0[0]
                y[oy:oy + bh, ox:ox + bw] = K.mc_luma(
                    r.y, PY + oy, PY + ox, bh, bw, mv[0], mv[1], sign, seq_bipred)
                u[oyC:oyC + bh // 2, oxC:oxC + bw // 2] = K.mc_chroma(
                    r.u, PC + oyC, PC + oxC, bh // 2, bw // 2, mv[0], mv[1], sign)
                v[oyC:oyC + bh // 2, oxC:oxC + bw // 2] = K.mc_chroma(
                    r.v, PC + oyC, PC + oxC, bh // 2, bw // 2, mv[0], mv[1], sign)
            continue

        # MERGE / INTER / BIPRED: build prediction block then add residual
        if b.mode == MODE_MERGE:
            if b.dir == 2:
                r0, r1 = ref_for(b.ref_idx0), ref_for(b.ref_idx1)
                s0 = 1 if r0.frame_num >= cur_num else 0
                s1 = 1 if r1.frame_num >= cur_num else 0
                mv0, mv1 = b.mv_arr0[0], b.mv_arr1[0]
                py_ = ((K.mc_luma(r0.y, PY + oy, PY + ox, bh, bw, mv0[0], mv0[1], s0, seq_bipred).astype(np.int32)
                        + K.mc_luma(r1.y, PY + oy, PY + ox, bh, bw, mv1[0], mv1[1], s1, seq_bipred)) >> 1).astype(np.uint8)
                pu_ = ((K.mc_chroma(r0.u, PC + oyC, PC + oxC, bh // 2, bw // 2, mv0[0], mv0[1], s0).astype(np.int32)
                        + K.mc_chroma(r1.u, PC + oyC, PC + oxC, bh // 2, bw // 2, mv1[0], mv1[1], s1)) >> 1).astype(np.uint8)
                pv_ = ((K.mc_chroma(r0.v, PC + oyC, PC + oxC, bh // 2, bw // 2, mv0[0], mv0[1], s0).astype(np.int32)
                        + K.mc_chroma(r1.v, PC + oyC, PC + oxC, bh // 2, bw // 2, mv1[0], mv1[1], s1)) >> 1).astype(np.uint8)
            else:
                r = ref_for(b.ref_idx0)
                sign = 1 if r.frame_num > cur_num else 0
                mv = b.mv_arr0[0]
                py_ = K.mc_luma(r.y, PY + oy, PY + ox, size, size, mv[0], mv[1], sign, seq_bipred)
                pu_ = K.mc_chroma(r.u, PC + oyC, PC + oxC, sizeC, sizeC, mv[0], mv[1], sign)
                pv_ = K.mc_chroma(r.v, PC + oyC, PC + oxC, sizeC, sizeC, mv[0], mv[1], sign)
        elif b.mode == MODE_INTER:
            r = ref_for(b.ref_idx0)
            sign = 1 if r.frame_num > cur_num else 0
            py_ = np.empty((size, size), np.uint8)
            pu_ = np.empty((sizeC, sizeC), np.uint8)
            pv_ = np.empty((sizeC, sizeC), np.uint8)
            ps, psC = size // 2, sizeC // 2
            for index in range(4):
                idx, idy = index & 1, (index >> 1) & 1
                mv = b.mv_arr0[index]
                py_[idy*ps:(idy+1)*ps, idx*ps:(idx+1)*ps] = K.mc_luma(
                    r.y, PY + oy + idy*ps, PY + ox + idx*ps, ps, ps, mv[0], mv[1], sign, seq_bipred)
                pu_[idy*psC:(idy+1)*psC, idx*psC:(idx+1)*psC] = K.mc_chroma(
                    r.u, PC + oyC + idy*psC, PC + oxC + idx*psC, psC, psC, mv[0], mv[1], sign)
                pv_[idy*psC:(idy+1)*psC, idx*psC:(idx+1)*psC] = K.mc_chroma(
                    r.v, PC + oyC + idy*psC, PC + oxC + idx*psC, psC, psC, mv[0], mv[1], sign)
        else:  # MODE_BIPRED
            r0, r1 = ref_for(b.ref_idx0), ref_for(b.ref_idx1)
            s0 = 1 if r0.frame_num >= cur_num else 0
            s1 = 1 if r1.frame_num >= cur_num else 0
            acc = []
            for (r, s, mvs) in ((r0, s0, b.mv_arr0), (r1, s1, b.mv_arr1)):
                py0 = np.empty((size, size), np.uint8)
                pu0 = np.empty((sizeC, sizeC), np.uint8)
                pv0 = np.empty((sizeC, sizeC), np.uint8)
                ps, psC = size // 2, sizeC // 2
                for index in range(4):
                    idx, idy = index & 1, (index >> 1) & 1
                    mv = mvs[index]
                    py0[idy*ps:(idy+1)*ps, idx*ps:(idx+1)*ps] = K.mc_luma(
                        r.y, PY + oy + idy*ps, PY + ox + idx*ps, ps, ps, mv[0], mv[1], s, seq_bipred)
                    pu0[idy*psC:(idy+1)*psC, idx*psC:(idx+1)*psC] = K.mc_chroma(
                        r.u, PC + oyC + idy*psC, PC + oxC + idx*psC, psC, psC, mv[0], mv[1], s)
                    pv0[idy*psC:(idy+1)*psC, idx*psC:(idx+1)*psC] = K.mc_chroma(
                        r.v, PC + oyC + idy*psC, PC + oxC + idx*psC, psC, psC, mv[0], mv[1], s)
                acc.append((py0, pu0, pv0))
            py_ = ((acc[0][0].astype(np.int32) + acc[1][0]) >> 1).astype(np.uint8)
            pu_ = ((acc[0][1].astype(np.int32) + acc[1][1]) >> 1).astype(np.uint8)
            pv_ = ((acc[0][2].astype(np.int32) + acc[1][2]) >> 1).astype(np.uint8)

        # residual add (decode_and_reconstruct_block_inter)
        tb = bool(b.tb_split)
        ry = _residual(b.coeff_y, size, qpY, tb)
        rc_tb = tb and size > 8
        ru = _residual(b.coeff_u, sizeC, qpC, rc_tb)
        rv = _residual(b.coeff_v, sizeC, qpC, rc_tb)
        y[oy:oy + size, ox:ox + size] = K.reconstruct_block(ry, py_)
        u[oyC:oyC + sizeC, oxC:oxC + sizeC] = K.reconstruct_block(ru, pu_)
        v[oyC:oyC + sizeC, oxC:oxC + sizeC] = K.reconstruct_block(rv, pv_)

    if deblocking:
        K.deblock_frame_y(y, fs.deblock_data, width, height, qp,
                          BETA_TABLE, TC_TABLE)
        qpc = int(CHROMA_QP[qp])
        K.deblock_frame_uv(u, v, fs.deblock_data, width, height, qpc, TC_TABLE)

    return y, u, v


def apply_clpf(fs: FrameSyntax, y, u, v, width, height):
    """CLPF application, fully vectorized
    (common/common_frame.c:485-557): dense whole-plane filtering +
    per-8x8 select masks. Filtering is SB-local (neighbour reads clamp
    at the SB boundary), so computing every SB from the pre-filter
    plane matches the reference's SB-by-SB in-place loop exactly."""
    if not fs.clpf_frame_enable:
        return
    dd = fs.deblock_data
    SBW, SBH = width // 64, height // 64
    if SBH == 0 or SBW == 0:
        return
    h8, w8 = SBH * 8, SBW * 8

    def cell8(a):
        return np.asarray(a)[::2, ::2][:h8, :w8]

    notbi = cell8(dd.mode) != MODE_BIPRED
    cy8 = (cell8(dd.cbp_y) > 0) & notbi
    cu8 = (cell8(dd.cbp_u) > 0) & notbi
    cv8 = (cell8(dd.cbp_v) > 0) & notbi
    cand_sb = (cy8 | cu8 | cv8).reshape(SBH, 8, SBW, 8).any(axis=(1, 3))
    if fs.clpf_all:
        on_sb = cand_sb
    else:
        on_sb = cand_sb & (np.asarray(fs.clpf_bits)[:SBH, :SBW] == 1)
    if not on_sb.any():
        return
    on8 = np.repeat(np.repeat(on_sb, 8, 0), 8, 1)

    def apply(plane, mask8, b, sbs, ww, hh):
        Fp = K.clpf_plane_dense(plane, sbs, ww, hh)
        m = np.repeat(np.repeat(mask8 & on8, b, 0), b, 1)
        reg = plane[:h8 * b, :w8 * b]
        plane[:h8 * b, :w8 * b] = np.where(m, Fp[:h8 * b, :w8 * b], reg)

    apply(y, cy8, 8, 64, width, height)
    apply(u, cu8, 4, 32, width // 2, height // 2)
    apply(v, cv8, 4, 32, width // 2, height // 2)
