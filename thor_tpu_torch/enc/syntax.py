"""Encoder-side syntax writers: the exact inverse of dec/read_bits.c,
mirroring enc/write_bits.c (cited per function).

These run host-side on precomputed coefficient planes / mode decisions;
the pixel math that produces them is batched work on the encoder's
device. Counterpart of thor_tpu/enc/syntax.py.
"""

from __future__ import annotations

import numpy as np

from ..bitstream.writer import BitWriter, put_vlc
from ..codec.constants import (
    I_FRAME, B_FRAME, MAX_BLOCK_SIZE, MAX_QUANT_SIZE, MIN_BLOCK_SIZE,
    MODE_BIPRED, MODE_INTER, MODE_INTRA, MODE_MERGE, MODE_SKIP, PART_NONE,
    PART_HOR, PART_VER, CBP_TABLE, zigzag_for)


def write_mv(w: BitWriter, mv, mvp):
    """enc/write_bits.c:50-69"""
    for comp in (0, 1):
        d = mv[comp] - mvp[comp]
        mvabs, mvsign = abs(d), (1 if d < 0 else 0)
        put_vlc(10, 2 * mvabs - mvsign, w)


def find_code(run, level, maxrun, chroma_flag, eob):
    """enc/write_bits.c:71-108"""
    maxrun2 = max(4, maxrun)
    index = run + (1 if level > 1 else 0) * (maxrun2 + 1)
    if chroma_flag:
        if eob:
            return 0
        if index <= 4:
            return index + 1
        if index <= maxrun2:
            return index + 3
        if index == maxrun2 + 1:
            return 6
        if index == maxrun2 + 2:
            return 7
        return index + 1
    if eob:
        return 2
    if index < 2:
        return index
    if index <= 4:
        return index + 1
    if index <= maxrun2:
        return index + 3
    if index == maxrun2 + 1:
        return 6
    if index == maxrun2 + 2:
        return 7
    return index + 1


def write_coeff(w: BitWriter, coeff: np.ndarray, size: int, type_: int):
    """Two-state level/run coefficient coding (enc/write_bits.c:110-253).

    coeff: (size, size) int plane with the quantized qsize x qsize
    low-frequency block at the top-left.
    """
    qsize = min(MAX_QUANT_SIZE, size)
    N = qsize * qsize
    chroma_flag = type_ & 1
    intra_flag = (type_ >> 1) & 1
    vlc_adaptive = 1 if (intra_flag and not chroma_flag) else 0

    zz = zigzag_for(qsize)
    scoeff = np.zeros(N, np.int32)
    scoeff[zz] = coeff[:qsize, :qsize].reshape(-1)
    scoeff = scoeff.tolist()

    pos = N - 1
    while scoeff[pos] == 0 and pos > 0:
        pos -= 1
    assert not (pos == 0 and scoeff[0] == 0), "cbp nonzero but no coeffs"
    last_pos = pos

    pos = 0
    if chroma_flag:
        if last_pos == 0 and abs(scoeff[0]) == 1:
            w.putbits(1, 1)
            w.putbits(1, 1 if scoeff[0] < 0 else 0)
            pos = N
        else:
            w.putbits(1, 0)

    level_mode = 1
    level = 1
    while pos <= last_pos:
        if level_mode:
            while pos <= last_pos and level > 0:
                c = scoeff[pos]
                level = abs(c)
                put_vlc(vlc_adaptive, level, w)
                if level > 0:
                    w.putbits(1, 1 if c < 0 else 0)
                if chroma_flag == 0:
                    vlc_adaptive = 1 if level > 3 else 0
                pos += 1
        maxrun = N - pos - 1
        run = 0
        c = 0
        while c == 0 and pos <= last_pos:
            c = scoeff[pos]
            if c == 0:
                run += 1
            else:
                level = abs(c)
                sign = 1 if c < 0 else 0
                cn = find_code(run, level, maxrun, chroma_flag, 0)
                if chroma_flag and size <= 8:
                    put_vlc(10, cn, w)
                else:
                    if cn == 0:
                        w.putbits(2, 2)
                    else:
                        put_vlc(2, cn + 1, w)
                if level > 1:
                    put_vlc(0, 2 * (level - 2) + sign, w)
                else:
                    w.putbits(1, sign)
                run = 0
            pos += 1
            level_mode = 1 if level > 1 else 0

    if pos < N and level_mode:
        c = scoeff[pos]
        level = abs(c)
        put_vlc(vlc_adaptive, level, w)
        if level > 0:
            w.putbits(1, 1 if c < 0 else 0)
        pos += 1

    if pos < N:
        cn = find_code(0, 0, 0, chroma_flag, 1)
        if chroma_flag and size <= 8:
            put_vlc(0, cn, w)
        else:
            if cn == 0:
                w.putbits(2, 2)
            else:
                put_vlc(2, cn + 1, w)


def write_delta_qp(w: BitWriter, delta_qp: int):
    """enc/write_bits.c:255-265"""
    put_vlc(0, abs(delta_qp), w)
    if delta_qp != 0:
        w.putbits(1, 1 if delta_qp < 0 else 0)


def write_super_mode(w: BitWriter, ectx, binfo, mode, ref_idx0, split_flag):
    """Joint split/mode/ref code (enc/write_bits.c:268-380).

    ectx: encoder frame context (frame_type, num_ref, interp_ref,
    enable_bipred); binfo: block info (size, block_context).
    """
    size = binfo.size
    if ectx.frame_type != I_FRAME:
        if split_flag:
            bc = binfo.block_context
            code = 1
            if bc.index == 2 or bc.index > 3:
                code = (code + 3) % 4
            w.putbits(code + 1, 1)
            return
        num_ref = ectx.num_ref
        bipred_possible = num_ref > 1 and ectx.enable_bipred
        split_possible = size > MIN_BLOCK_SIZE
        maxbit = 2 + num_ref + int(split_possible) + int(bipred_possible)
        if ectx.interp_ref:
            if mode == MODE_SKIP:
                code = 0
            elif mode == MODE_MERGE:
                code = 2
            elif mode == MODE_BIPRED:
                code = 3
            elif mode == MODE_INTRA:
                code = 4
            elif mode == MODE_INTER and ref_idx0 > 0:
                code = 4 + ref_idx0
            else:
                code = 4 + num_ref
            if not bipred_possible and code > 3:
                code -= 1
            if not split_possible and code > 1:
                code -= 1
            bc = binfo.block_context
            if (bc.index == 2 or bc.index > 3) and size > MIN_BLOCK_SIZE:
                if code < 3:
                    code = (code + 2) % 3
        else:
            if mode == MODE_SKIP:
                code = 0
            elif mode == MODE_INTER and ref_idx0 == 0:
                code = 2
            elif mode == MODE_MERGE:
                code = 3
            elif mode == MODE_BIPRED:
                code = 4
            elif mode == MODE_INTRA:
                code = 5
            else:
                code = 5 + ref_idx0
            if not bipred_possible and code > 4:
                code -= 1
            if not split_possible and code > 1:
                code -= 1
            bc = binfo.block_context
            if (bc.index == 2 or bc.index > 3) and size > MIN_BLOCK_SIZE:
                if code < 4:
                    code = (code + 3) % 4
        if code == maxbit:
            w.putbits(maxbit, 0)
        else:
            w.putbits(code + 1, 1)
    else:
        if size > MIN_BLOCK_SIZE or split_flag == 1:
            w.putbits(1, split_flag)


INTRA_MODE_MAP_8 = [2, 8, 1, 0, 5, 9, 7, 6, 4, 3]
INTRA_LEN_8 = [2, 2, 2, 4, 4, 4, 5, 5]
INTRA_CODE_8 = [0, 1, 2, 12, 13, 14, 30, 31]
INTRA_MODE_MAP_10 = [2, 3, 1, 0, 6, 9, 8, 7, 5, 4]
INTRA_LEN_10 = [2, 2, 3, 3, 4, 4, 5, 5, 5, 5]
INTRA_CODE_10 = [2, 3, 2, 3, 2, 3, 0, 1, 2, 3]


def write_block(w: BitWriter, ectx, binfo, bp):
    """Full per-block syntax (enc/write_bits.c:382-650). Returns nbits.

    bp: chosen block parameters (mode, intra_mode, mv_arr0/1, ref idx,
    skip_idx, pb_part, tb_split, cbp tuple or per-TU cbp list, coeff
    planes).
    """
    size = binfo.size
    mode = bp.mode
    start_bits = w.get_bit_pos()
    coeff_type = (1 if mode == MODE_INTRA else 0) << 1

    write_super_mode(w, ectx, binfo, mode, bp.ref_idx0, 0)

    if size == MAX_BLOCK_SIZE and mode != MODE_SKIP and ectx.max_delta_qp:
        write_delta_qp(w, binfo.delta_qp)

    if mode == MODE_INTRA:
        n = ectx.num_intra_modes
        if n <= 4:
            w.putbits(2, bp.intra_mode)
        elif n <= 8:
            code = INTRA_MODE_MAP_8[bp.intra_mode]
            w.putbits(INTRA_LEN_8[code], INTRA_CODE_8[code])
        else:
            code = INTRA_MODE_MAP_10[bp.intra_mode]
            w.putbits(INTRA_LEN_10[code], INTRA_CODE_10[code])
    elif mode == MODE_INTER:
        if binfo.max_num_pb_part > 1:
            if bp.pb_part == 0:
                w.putbits(1, 1)
            elif bp.pb_part == 1:
                w.putbits(2, 1)
            elif bp.pb_part == 2:
                w.putbits(3, 1)
            else:
                w.putbits(3, 0)
        mvp2 = binfo.mvp
        if bp.pb_part == PART_NONE:
            write_mv(w, bp.mv_arr0[0], mvp2)
        elif bp.pb_part == PART_HOR:
            write_mv(w, bp.mv_arr0[0], mvp2)
            write_mv(w, bp.mv_arr0[2], bp.mv_arr0[0])
        elif bp.pb_part == PART_VER:
            write_mv(w, bp.mv_arr0[0], mvp2)
            write_mv(w, bp.mv_arr0[1], bp.mv_arr0[0])
        else:
            write_mv(w, bp.mv_arr0[0], mvp2)
            write_mv(w, bp.mv_arr0[1], bp.mv_arr0[0])
            write_mv(w, bp.mv_arr0[2], bp.mv_arr0[0])
            write_mv(w, bp.mv_arr0[3], bp.mv_arr0[0])
    elif mode == MODE_BIPRED:
        # BIPRED_PART=0: pb_part is always PART_NONE
        mvp2 = binfo.mvp
        write_mv(w, bp.mv_arr0[0], mvp2)
        if ectx.frame_type == B_FRAME:
            mvp2 = bp.mv_arr0[0]
        write_mv(w, bp.mv_arr1[0], mvp2)
        if ectx.frame_type == 1:  # P_FRAME
            if ectx.num_ref == 2:
                code = 2 * bp.ref_idx0 + bp.ref_idx1
                if code == 3:
                    w.putbits(3, 0)
                else:
                    w.putbits(code + 1, 1)
            else:
                put_vlc(10, 4 * bp.ref_idx0 + bp.ref_idx1, w)
    elif mode in (MODE_SKIP, MODE_MERGE):
        nvec = binfo.num_skip_vec if mode == MODE_SKIP else binfo.num_merge_vec
        if nvec == 4:
            w.putbits(2, bp.skip_idx)
        elif nvec == 3:
            if bp.skip_idx == 0:
                w.putbits(1, 1)
            elif bp.skip_idx == 1:
                w.putbits(2, 0)
            else:
                w.putbits(2, 1)
        elif nvec == 2:
            w.putbits(1, bp.skip_idx)

    if mode != MODE_SKIP:
        tb_split = bp.tb_split
        if mode in (MODE_MERGE, MODE_BIPRED):
            max_num_tb_part = 1
        elif mode == MODE_INTER:
            max_num_tb_part = 2 if binfo.max_num_tb_part > 1 else 1
        else:
            max_num_tb_part = binfo.max_num_tb_part

        cbp_y, cbp_u, cbp_v = bp.cbp
        if max_num_tb_part > 1:
            if tb_split:
                code = 2
            else:
                cbp = cbp_y + (cbp_u << 1) + (cbp_v << 2)
                code = CBP_TABLE[cbp]
                if binfo.block_context.cbp == 0 and code < 2:
                    code = 1 - code
                if code > 1:
                    code += 1
        else:
            cbp = cbp_y + (cbp_u << 1) + (cbp_v << 2)
            code = CBP_TABLE[cbp]
            if mode == MODE_MERGE:
                if code == 1:
                    code = 7
                elif code > 1:
                    code = code - 1
            else:
                if binfo.block_context.cbp == 0 and code < 2:
                    code = 1 - code
        put_vlc(0, code, w)

        if tb_split == 0:
            if cbp_y:
                write_coeff(w, bp.coeff_y, size, coeff_type | 0)
            if cbp_u:
                write_coeff(w, bp.coeff_u, size // 2, coeff_type | 1)
            if cbp_v:
                write_coeff(w, bp.coeff_v, size // 2, coeff_type | 1)
        else:
            # Per-TU cbp masks: bit (3-index) of bp.cbp components
            if size > 8:
                s2, s4 = size // 2, size // 4
                for index in range(4):
                    cy = (cbp_y >> (3 - index)) & 1
                    cu = (cbp_u >> (3 - index)) & 1
                    cv = (cbp_v >> (3 - index)) & 1
                    cbp = cy + (cu << 1) + (cv << 2)
                    code = CBP_TABLE[cbp]
                    if binfo.block_context.cbp == 0 and code < 2:
                        code = 1 - code
                    put_vlc(0, code, w)
                    i, j = (index >> 1) & 1, index & 1
                    if cy:
                        write_coeff(w, bp.coeff_y[i*s2:(i+1)*s2, j*s2:(j+1)*s2],
                                    s2, coeff_type | 0)
                    if cu:
                        write_coeff(w, bp.coeff_u[i*s4:(i+1)*s4, j*s4:(j+1)*s4],
                                    s4, coeff_type | 1)
                    if cv:
                        write_coeff(w, bp.coeff_v[i*s4:(i+1)*s4, j*s4:(j+1)*s4],
                                    s4, coeff_type | 1)
            else:
                s2 = size // 2
                for index in range(4):
                    cy = (cbp_y >> (3 - index)) & 1
                    w.putbits(1, cy)
                    i, j = (index >> 1) & 1, index & 1
                    if cy:
                        write_coeff(w, bp.coeff_y[i*s2:(i+1)*s2, j*s2:(j+1)*s2],
                                    s2, coeff_type | 0)
                cbp = cbp_u + 2 * cbp_v
                if cbp == 0:
                    w.putbits(1, 1)
                elif cbp == 1:
                    w.putbits(2, 1)
                elif cbp == 2:
                    w.putbits(3, 1)
                else:
                    w.putbits(3, 0)
                if cbp_u:
                    write_coeff(w, bp.coeff_u, size // 2, coeff_type | 1)
                if cbp_v:
                    write_coeff(w, bp.coeff_v, size // 2, coeff_type | 1)

    return w.get_bit_pos() - start_bits
