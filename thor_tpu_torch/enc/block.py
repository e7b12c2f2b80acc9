"""Block level of the host mirror encoder: the quadtree RDO loop, the
mode decision and the intra block encode.

Counterpart of thor_tpu/enc/block.py, mirroring enc/encode_block.c
(cited per function). The quadtree RDO uses the mirror's reconstructed
planes (numpy, enc/host.HostMirror) directly as the trial scratch, with
region backup/restore replacing the reference's local rec_block buffers,
and the BitWriter's checkpoint/rewind as the exact counterpart of the
reference's stream_pos trick. BlockParam and BlockInfo are also the
records the device encoder's syntax writers consume.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..bitstream.writer import BitWriter
from ..codec.blockdata import (
    find_block_contexts, get_downleft_available, get_upright_available,
    get_mv_merge, get_mv_pred, get_mv_skip)
from ..codec.constants import (
    B_FRAME, CHROMA_QP, I_FRAME, MAX_BLOCK_SIZE, MIN_BLOCK_SIZE, MODE_BIPRED,
    MODE_DC, MODE_HOR, MODE_INTER, MODE_INTRA, MODE_MERGE, MODE_PLANAR,
    MODE_SKIP, MODE_VER)
from ..ops import np_kernels as K
from .inter import (add_mvcandidate, motion_estimate_bi,
                    search_inter_prediction_params)
from .quant import quantize
from .syntax import write_block, write_delta_qp, write_super_mode

# Intra-mode evaluation order of the SAD search
# (search_intra_prediction_params, enc/encode_block.c:1240-1330)
_SAD_MODES_4 = [MODE_DC, MODE_HOR, MODE_VER, MODE_PLANAR]
_SAD_MODES_10 = _SAD_MODES_4 + [4, 5, 6, 7, 8, 9]

# RDO-based search for best QP (enc/encode_block.c:2966-2970)
IQ_8X8 = [6, 7, 8, 8, 10, 11, 12, 13, 15, 17, 19, 21, 24, 27, 30, 34,
          38, 43, 48, 54, 60, 68, 76, 86, 96, 108, 121, 136, 152, 171,
          192, 216, 242, 272, 305, 342, 384, 431, 484, 543, 610, 684,
          768, 862, 968, 1086, 1219, 1368, 1536, 1724, 1935, 2172]


@dataclass
class BlockParam:
    """block_param_t (common/types.h:153-170)."""
    mode: int = MODE_SKIP
    intra_mode: int = MODE_DC
    tb_param: int = 0
    tb_split: int = 0
    pb_part: int = 0
    skip_idx: int = 0
    ref_idx0: int = 0
    ref_idx1: int = 0
    dir: int = 0
    mv_arr0: tuple = (((0, 0),) * 4)
    mv_arr1: tuple = (((0, 0),) * 4)
    cbp: tuple = (0, 0, 0)
    coeff_y: Optional[np.ndarray] = None
    coeff_u: Optional[np.ndarray] = None
    coeff_v: Optional[np.ndarray] = None


@dataclass
class BlockInfo:
    """block_info_t subset used by the syntax writers and RDO."""
    size: int = 0
    ypos: int = 0
    xpos: int = 0
    bwidth: int = 0
    bheight: int = 0
    max_num_tb_part: int = 1
    max_num_pb_part: int = 1
    delta_qp: int = 0
    block_context: object = None
    mvp: tuple = (0, 0)
    num_skip_vec: int = 0
    num_merge_vec: int = 0
    skip_candidates: list = field(default_factory=list)
    merge_candidates: list = field(default_factory=list)
    block_param: BlockParam = field(default_factory=BlockParam)


def ssd_block(a, b):
    d = a.astype(np.int32) - b.astype(np.int32)
    return int((d * d).sum())


def sad_block(a, b):
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).sum())


def cost_calc(enc, binfo, nbits):
    """SSD(Y)+SSD(U)+SSD(V) + lambda*bits (enc/encode_block.c:1218-1228),
    computed over the trial region of the rec planes vs the original
    (bwidth x bheight; equal to size x size except rectangular skips)."""
    y0, x0 = binfo.ypos, binfo.xpos
    bw, bh = binfo.bwidth, binfo.bheight
    yc, xc, wc, hc = y0 // 2, x0 // 2, bw // 2, bh // 2
    ssd = (ssd_block(enc.org_y[y0:y0+bh, x0:x0+bw], enc.rec_y[y0:y0+bh, x0:x0+bw])
           + ssd_block(enc.org_u[yc:yc+hc, xc:xc+wc], enc.rec_u[yc:yc+hc, xc:xc+wc])
           + ssd_block(enc.org_v[yc:yc+hc, xc:xc+wc], enc.rec_v[yc:yc+hc, xc:xc+wc]))
    cost = ssd + int(enc.lambda_ * nbits + 0.5)
    return min(cost, 1 << 30)


def _intra_plane(enc, plane, org, ypos, xpos, size, qp, coeff_type,
                 tb_split, intra_mode, upright_av, downleft_av, cb_xpos,
                 fast, rdoq):
    """encode_and_reconstruct_block_intra for one plane
    (enc/encode_block.c:1398-1467). Writes recon into `plane` in place;
    returns (cbp_mask, coeffq full-size plane)."""
    coeffq = np.zeros((size, size), np.int16)
    if tb_split:
        s2 = size // 2
        cbp = 0
        for i in (0, s2):
            for j in (0, s2):
                up = (j == 0) or (i == 0 and upright_av)
                dl = (j == 0) and (i == 0 or downleft_av)
                left, top, tl = K.make_top_and_left(
                    plane, ypos + i, xpos + j, cb_xpos, s2, up, dl)
                pred = K.intra_prediction(left, top, tl, ypos + i, xpos + j,
                                          s2, intra_mode)
                resid = (org[i:i+s2, j:j+s2].astype(np.int16)
                         - pred.astype(np.int16))
                coeff = K.transform_fwd(resid, s2, fast)
                cbpbit, cq = quantize(coeff, qp, s2, coeff_type, rdoq)
                if cbpbit:
                    rres = K.inverse_transform(K.dequantize(cq, qp), s2)
                    rec = K.reconstruct_block(rres, pred)
                else:
                    rec = pred
                coeffq[i:i+s2, j:j+s2] = cq
                cbp = (cbp << 1) + cbpbit
                plane[ypos+i:ypos+i+s2, xpos+j:xpos+j+s2] = rec
        return cbp, coeffq
    left, top, tl = K.make_top_and_left(
        plane, ypos, xpos, cb_xpos, size, upright_av, downleft_av)
    pred = K.intra_prediction(left, top, tl, ypos, xpos, size, intra_mode)
    resid = org.astype(np.int16) - pred.astype(np.int16)
    coeff = K.transform_fwd(resid, size, fast)
    cbp, cq = quantize(coeff, qp, size, coeff_type, rdoq)
    if cbp:
        rres = K.inverse_transform(K.dequantize(cq, qp), size)
        rec = K.reconstruct_block(rres, pred)
    else:
        rec = pred
    plane[ypos:ypos+size, xpos:xpos+size] = rec
    return cbp, cq


def encode_block(enc, w: BitWriter, binfo: BlockInfo, bp: BlockParam):
    """Trial/final encode of one block with the given parameters
    (enc/encode_block.c:1590-1800). Reconstructs into the frame rec
    planes and writes syntax; returns nbits."""
    size = binfo.size
    ypos, xpos = binfo.ypos, binfo.xpos
    yc, xc, sc = ypos // 2, xpos // 2, size // 2
    qpY = enc.frame_qp + binfo.delta_qp
    qpC = int(CHROMA_QP[qpY])
    tb_split = max(0, bp.tb_param)
    bp.tb_split = tb_split

    if bp.mode == MODE_INTRA:
        fast = enc.params.encoder_speed > 1
        upright_av = get_upright_available(ypos, xpos, size, enc.width)
        downleft_av = get_downleft_available(ypos, xpos, size, enc.height)
        it = (enc.frame_type == I_FRAME) << 1
        cy, bp.coeff_y = _intra_plane(
            enc, enc.rec_y, enc.org_y[ypos:ypos+size, xpos:xpos+size],
            ypos, xpos, size, qpY, it | 0, tb_split, bp.intra_mode,
            upright_av, downleft_av, xpos, fast, enc.params.rdoq)
        cu, bp.coeff_u = _intra_plane(
            enc, enc.rec_u, enc.org_u[yc:yc+sc, xc:xc+sc],
            yc, xc, sc, qpC, it | 1, tb_split and size > 8, bp.intra_mode,
            upright_av, downleft_av, xc, fast, enc.params.rdoq)
        cv, bp.coeff_v = _intra_plane(
            enc, enc.rec_v, enc.org_v[yc:yc+sc, xc:xc+sc],
            yc, xc, sc, qpC, it | 1, tb_split and size > 8, bp.intra_mode,
            upright_av, downleft_av, xc, fast, enc.params.rdoq)
        bp.cbp = (cy, cu, cv)
    else:
        enc.encode_inter_block(w, binfo, bp, qpY, qpC)

    return write_block(w, enc, binfo, bp)


def search_intra_mode_sad(enc, binfo, num_intra_modes):
    """SAD-based intra mode pre-search
    (search_intra_prediction_params, enc/encode_block.c:1240-1330).
    Note the reference always selects the `left`/`top` arrays for the DC
    sum here (xposY >= 0 is always true), unlike the final prediction."""
    ypos, xpos, size = binfo.ypos, binfo.xpos, binfo.size
    upright_av = get_upright_available(ypos, xpos, size, enc.width)
    downleft_av = get_downleft_available(ypos, xpos, size, enc.height)
    left, top, tl = K.make_top_and_left(
        enc.rec_y, ypos, xpos, xpos, size, upright_av, downleft_av)
    org = enc.org_y[ypos:ypos+size, xpos:xpos+size]
    modes = _SAD_MODES_4 if num_intra_modes == 4 else _SAD_MODES_10
    best_mode, min_sad = MODE_DC, 1 << 30
    for mode in modes:
        # ypos/xpos passed nonzero so DC uses left+top (the search's
        # fixed selection), matching the reference's get_dc_pred call.
        pred = K.intra_prediction(left, top, tl, 1, 1, size, mode)
        sad = sad_block(org, pred)
        if sad < min_sad:
            best_mode, min_sad = mode, sad
    return best_mode, min_sad


def mode_decision_rdo(enc, w: BitWriter, binfo: BlockInfo):
    """RDO over modes (enc/encode_block.c:2204-2479). Trials append to
    the stream (bits counted inside write_block) and everything is
    rewound at the end, exactly like the reference."""
    size = binfo.size
    stream_pos_ref = w.save()
    min_cost = (1 << 32) - 1
    tmp = BlockParam()
    region = enc.save_region(binfo)
    p = enc.params
    do_intra = True
    do_inter = True
    intra_inter_sad = p.encoder_speed > 0 and not p.sync
    sad_intra = (1 << 32) - 1

    if enc.frame_type != I_FRAME:
        # --- SKIP candidates (enc/encode_block.c:2254-2279) ---
        tmp.tb_param = 0
        tmp.pb_part = 0
        for skip_idx, c in enumerate(binfo.skip_candidates):
            tmp.skip_idx = skip_idx
            tmp.ref_idx0, tmp.ref_idx1 = c.ref_idx0, c.ref_idx1
            tmp.mv_arr0 = [(c.mv0x, c.mv0y)] * 4
            tmp.mv_arr1 = [(c.mv1x, c.mv1y)] * 4
            tmp.dir = c.bipred_flag
            tmp.mode = MODE_SKIP
            nbits = encode_block(enc, w, binfo, tmp)
            cost = cost_calc(enc, binfo, nbits)
            if cost < min_cost:
                min_cost = cost
                binfo.block_param = _copy_param(tmp)

    rectangular = (binfo.bwidth != size or binfo.bheight != size)
    if not rectangular and size <= 64:
        if enc.frame_type != I_FRAME:
            # --- MERGE candidates (enc/encode_block.c:2287-2304) ---
            tmp.tb_param = 0
            for merge_idx, c in enumerate(binfo.merge_candidates):
                tmp.skip_idx = merge_idx
                tmp.ref_idx0, tmp.ref_idx1 = c.ref_idx0, c.ref_idx1
                tmp.mv_arr0 = [(c.mv0x, c.mv0y)] * 4
                tmp.mv_arr1 = [(c.mv1x, c.mv1y)] * 4
                tmp.dir = c.bipred_flag
                tmp.mode = MODE_MERGE
                nbits = encode_block(enc, w, binfo, tmp)
                cost = cost_calc(enc, binfo, nbits)
                if cost < min_cost:
                    min_cost = cost
                    binfo.block_param = _copy_param(tmp)

            if intra_inter_sad:
                intra_mode_sad, sad_intra = search_intra_mode_sad(
                    enc, binfo, enc.num_intra_modes)
                sad_intra += int(math.sqrt(enc.lambda_) * 2 + 0.5)

            # --- INTER per reference (enc/encode_block.c:2312-2373) ---
            if (enc.best_ref < 0 or p.encoder_speed < 2
                    or p.enable_bipred or p.sync):
                min_idx, max_idx = 0, enc.num_ref - 1
            else:
                min_idx = max_idx = enc.best_ref
            lambda_me = math.sqrt(enc.lambda_)
            worst_cost, best_cost = 0, (1 << 32) - 1
            org = enc.org_y[binfo.ypos:binfo.ypos + size,
                            binfo.xpos:binfo.xpos + size]
            mv_center_map = {}
            for ref_idx in range(min_idx, max_idx + 1):
                ref = enc.get_ref(ref_idx)
                tmp.ref_idx0 = tmp.ref_idx1 = ref_idx
                mvp = binfo.mvp
                cl = enc.mvcand_for(ref_idx)
                add_mvcandidate(mvp, cl)
                sign = 1 if ref.frame_num >= enc.frame_num else 0
                mv_center = mvp
                sad_inter = (1 << 32) - 1
                mv_parts = {}
                for part in range(binfo.max_num_pb_part):
                    sad, mv_arr = search_inter_prediction_params(
                        org, ref.y, binfo, mv_center, mvp, part,
                        lambda_me, p, sign, enc.width, enc.height, cl,
                        p.enable_bipred)
                    for mv in mv_arr:
                        add_mvcandidate(mv, cl)
                    mv_parts[part] = mv_arr
                    mv_center = mv_parts[0][0]
                    sad_inter = min(sad_inter, sad)
                mv_center_map[ref_idx] = mv_center
                if intra_inter_sad:
                    do_inter = sad_inter < sad_intra
                    if sad_inter < sad_intra:
                        do_intra = False
                if do_inter:
                    min_tb = -1 if p.encoder_speed < 1 else 0
                    max_tb = binfo.max_num_tb_part - 1
                    tmp.mode = MODE_INTER
                    tmp.dir = 0
                    for part in range(binfo.max_num_pb_part):
                        tmp.pb_part = part
                        tmp.mv_arr0 = list(mv_parts[part])
                        tmp.mv_arr1 = list(mv_parts[part])
                        for tb_param in range(min_tb, max_tb + 1):
                            tmp.tb_param = tb_param
                            nbits = encode_block(enc, w, binfo, tmp)
                            cost = cost_calc(enc, binfo, nbits)
                            worst_cost = max(worst_cost, cost)
                            best_cost = min(best_cost, cost)
                            if cost < min_cost:
                                min_cost = cost
                                binfo.block_param = _copy_param(tmp)
            if worst_cost and worst_cost * 3 > best_cost * 4:
                enc.best_ref = 0

            # --- BIPRED (enc/encode_block.c:2379-2427) ---
            if enc.num_ref > 1 and p.enable_bipred and do_inter:
                for part in range(1):  # BIPRED_PART=0: single partition
                    (r0, r1, a0, a1) = _search_bipred(
                        enc, binfo, part, mv_center_map, binfo.mvp)
                    tmp.pb_part = part
                    tmp.ref_idx0, tmp.ref_idx1 = r0, r1
                    tmp.mv_arr0 = list(a0)
                    tmp.mv_arr1 = list(a1)
                    tmp.mode = MODE_BIPRED
                    tmp.dir = 2
                    for tb_param in range(0, 1):
                        tmp.tb_param = tb_param
                        nbits = encode_block(enc, w, binfo, tmp)
                        cost = cost_calc(enc, binfo, nbits)
                        if cost < min_cost:
                            min_cost = cost
                            binfo.block_param = _copy_param(tmp)
                if (enc.frame_type == B_FRAME
                        and p.encoder_speed == 0):
                    (r0, r1, a0, a1) = _search_bipred(
                        enc, binfo, 0, mv_center_map, binfo.mvp,
                        me_mode=1)
                    tmp.pb_part = 0
                    tmp.ref_idx0, tmp.ref_idx1 = r0, r1
                    tmp.mv_arr0 = list(a0)
                    tmp.mv_arr1 = list(a1)
                    tmp.tb_param = 0
                    tmp.mode = MODE_BIPRED
                    tmp.dir = 2
                    nbits = encode_block(enc, w, binfo, tmp)
                    cost = cost_calc(enc, binfo, nbits)
                    if cost < min_cost:
                        min_cost = cost
                        binfo.block_param = _copy_param(tmp)

        if do_intra:
            max_tb_param = binfo.max_num_tb_part - 1
            if enc.params.intra_rdo:
                min_intra_cost = (1 << 32) - 1
                best_intra_mode = MODE_DC
                for intra_mode in range(enc.num_intra_modes):
                    tmp.intra_mode = intra_mode
                    for tb_param in range(0, max_tb_param + 1):
                        tmp.tb_param = tb_param
                        tmp.mode = MODE_INTRA
                        nbits = encode_block(enc, w, binfo, tmp)
                        cost = cost_calc(enc, binfo, nbits)
                        if cost < min_intra_cost:
                            min_intra_cost = cost
                            best_intra_mode = intra_mode
                intra_mode = best_intra_mode
            else:
                intra_mode, _ = search_intra_mode_sad(
                    enc, binfo, enc.num_intra_modes)
            tmp.intra_mode = intra_mode
            for tb_param in range(0, max_tb_param + 1):
                tmp.tb_param = tb_param
                tmp.mode = MODE_INTRA
                nbits = encode_block(enc, w, binfo, tmp)
                cost = cost_calc(enc, binfo, nbits)
                if cost < min_cost:
                    min_cost = cost
                    binfo.block_param = _copy_param(tmp)

    enc.restore_region(binfo, region)
    w.restore(stream_pos_ref)
    return min_cost


def _search_bipred(enc, binfo, part, mv_center_map, mvp, me_mode=0):
    """search_bipred_prediction_params (enc/encode_block.c:2047-2203):
    me_mode=1 is the symmetric mv0=-mv1 joint search; otherwise an
    iterative per-list unipred search against the doubled residual
    target org8 = clip255(2*org - other_list_pred)."""
    p = enc.params
    size = binfo.size
    ypos, xpos = binfo.ypos, binfo.xpos
    lambda_me = math.sqrt(enc.lambda_)
    org_y = enc.org_y[ypos:ypos + size, xpos:xpos + size]

    if me_mode:
        r_idx0 = 1 if enc.interp_ref else 0
        r_idx1 = 2 if enc.interp_ref else 1
        ref0 = enc.get_ref(r_idx0)
        ref1 = enc.get_ref(r_idx1)
        cl = enc.mvcand_for(r_idx0)
        _, mv = motion_estimate_bi(
            org_y, ref0.y, ref1.y, size, size, size,
            mv_center_map.get(r_idx0, mvp), mvp, lambda_me, p, 0,
            enc.width, enc.height, xpos, ypos, cl, 2)
        return r_idx0, r_idx1, [mv] * 4, [mv] * 4

    ref_idx = 1 if (enc.frame_type == B_FRAME and enc.interp_ref == 1) \
        else 0
    min_ref0, min_ref1 = ref_idx, 0
    min_arr0 = [tuple(mvp)] * 4
    min_arr1 = [tuple(mvp)] * 4
    min_sad = 1 << 30
    num_iter = 2 if p.encoder_speed == 0 else 1

    for _n in range(num_iter):
        stop = 0 if part == 0 else 1
        for list_ in range(1, stop - 1, -1):
            mv = (min_arr0 if list_ else min_arr1)[0]
            other_idx = min_ref0 if list_ else min_ref1
            ref = enc.get_ref(other_idx)
            sign = 1 if ref.frame_num > enc.frame_num else 0
            py, _pu, _pv = enc._pred_yuv(
                ref, binfo, min_arr0 if list_ else min_arr1, sign, 1)
            org8 = np.clip(2 * org_y.astype(np.int16)
                           - py.astype(np.int16), 0, 255).astype(np.uint8)

            if enc.frame_type == 1:  # P_FRAME
                ref_start, ref_end = 0, enc.num_ref - 1
            else:
                ref_start = ref_end = \
                    (1 if list_ else 0) + (1 if enc.interp_ref else 0)
            for ref_idx in range(ref_start, ref_end + 1):
                ref = enc.get_ref(ref_idx)
                sign = 1 if ref.frame_num > enc.frame_num else 0
                mvp2 = mv if (enc.frame_type == B_FRAME and list_ == 1) \
                    else mvp
                mvc = mv_center_map.get(ref_idx, mvp)
                cl = enc.mvcand_for(ref_idx)
                sad, mv_all = search_inter_prediction_params(
                    org8, ref.y, binfo, mvc, mvp2, part, lambda_me, p,
                    sign, enc.width, enc.height, cl, 1)
                for m in mv_all:
                    add_mvcandidate(m, cl)
                if sad < min_sad:
                    min_sad = sad
                    if list_:
                        min_ref1 = ref_idx
                        min_arr1 = list(mv_all)
                    else:
                        min_ref0 = ref_idx
                        min_arr0 = list(mv_all)
    return min_ref0, min_ref1, min_arr0, min_arr1


def _copy_param(bp: BlockParam) -> BlockParam:
    """Mirror of copy_best_parameters (enc/encode_block.c:1983-2045)
    including its per-mode side-info normalization (INTRA stores dir=-1,
    zero MVs, ref 0; INTER dir=0; BIPRED dir=2)."""
    out = BlockParam(
        mode=bp.mode, intra_mode=bp.intra_mode, tb_param=bp.tb_param,
        tb_split=bp.tb_split, pb_part=bp.pb_part, skip_idx=bp.skip_idx,
        ref_idx0=bp.ref_idx0, ref_idx1=bp.ref_idx1, dir=bp.dir,
        mv_arr0=tuple(bp.mv_arr0), mv_arr1=tuple(bp.mv_arr1),
        cbp=tuple(bp.cbp) if isinstance(bp.cbp, tuple) else bp.cbp)
    if bp.mode == MODE_INTRA:
        out.ref_idx0 = out.ref_idx1 = 0
        out.mv_arr0 = ((0, 0),) * 4
        out.mv_arr1 = ((0, 0),) * 4
        out.dir = -1
    elif bp.mode == MODE_INTER:
        out.dir = 0
    elif bp.mode == MODE_BIPRED:
        out.dir = 2
    out.coeff_y = None if bp.coeff_y is None else bp.coeff_y.copy()
    out.coeff_u = None if bp.coeff_u is None else bp.coeff_u.copy()
    out.coeff_v = None if bp.coeff_v is None else bp.coeff_v.copy()
    return out


def process_block(enc, w: BitWriter, size, ypos, xpos, qp):
    """Quadtree recursion with stream rewind/replay
    (enc/encode_block.c:2787-3033)."""
    height, width = enc.height, enc.width
    if ypos >= height or xpos >= width:
        return 0
    frame_type = enc.frame_type
    p = enc.params
    encode_this_size = ypos + size <= height and xpos + size <= width
    factor = 2 if (encode_this_size and frame_type != I_FRAME
                   and not p.sync and p.encoder_speed > 0) else 1
    encode_smaller_size = size > MIN_BLOCK_SIZE * factor
    top_down = (not encode_smaller_size) and size > MIN_BLOCK_SIZE
    encode_rectangular_size = (not encode_this_size
                               and frame_type != I_FRAME)
    if not encode_this_size and not encode_smaller_size:
        return 0
    cost_small = 1 << 28
    cost = 1 << 28

    stream_pos_ref = w.save()
    binfo = BlockInfo(
        size=size, ypos=ypos, xpos=xpos,
        bwidth=min(size, width - xpos), bheight=min(size, height - ypos),
        max_num_tb_part=2 if p.enable_tb_split == 1 else 1,
        max_num_pb_part=4 if p.enable_pb_split else 1,
        delta_qp=qp - enc.frame_qp)
    binfo.block_context = find_block_contexts(
        ypos, xpos, height, width, size, enc.deblock_data,
        bool(p.use_block_contexts))

    if frame_type != I_FRAME:
        binfo.skip_candidates = get_mv_skip(
            ypos, xpos, width, height, size, enc.deblock_data)
        binfo.num_skip_vec = len(binfo.skip_candidates)
        binfo.merge_candidates = get_mv_merge(
            ypos, xpos, width, height, size, enc.deblock_data)
        binfo.num_merge_vec = len(binfo.merge_candidates)
        if binfo.bwidth == size and binfo.bheight == size:
            binfo.mvp = get_mv_pred(ypos, xpos, width, height, size,
                                    enc.deblock_data)

    if encode_this_size and frame_type != I_FRAME and p.early_skip_thr > 0.0:
        early_skip_flag = enc.search_early_skip(w, binfo)
        w.restore(stream_pos_ref)
        if early_skip_flag:
            binfo.block_param.mode = MODE_SKIP
            binfo.block_param.tb_param = 0
            nbit = encode_block(enc, w, binfo, binfo.block_param)
            cost = cost_calc(enc, binfo, nbit)
            enc.store_deblock_data(binfo)
            return cost

    if encode_smaller_size:
        new_size = size // 2
        if encode_this_size:
            write_super_mode(w, enc, binfo, MODE_SKIP, 0, 1)
        elif frame_type != I_FRAME:
            w.putbits(1, 0)
        if size == MAX_BLOCK_SIZE and p.max_delta_qp:
            write_delta_qp(w, binfo.delta_qp)
        cost_small = 0
        cost_small += process_block(enc, w, new_size, ypos, xpos, qp)
        cost_small += process_block(enc, w, new_size, ypos + new_size, xpos, qp)
        cost_small += process_block(enc, w, new_size, ypos, xpos + new_size, qp)
        cost_small += process_block(enc, w, new_size, ypos + new_size,
                                    xpos + new_size, qp)

    if encode_this_size:
        cost = mode_decision_rdo(enc, w, binfo)

        me_threshold = size * size * IQ_8X8[qp] // 8
        if top_down and cost > me_threshold:
            new_size = size // 2
            write_super_mode(w, enc, binfo, MODE_SKIP, 0, 1)
            cost_small = 0
            cost_small += process_block(enc, w, new_size, ypos, xpos, qp)
            cost_small += process_block(enc, w, new_size, ypos + new_size, xpos, qp)
            cost_small += process_block(enc, w, new_size, ypos, xpos + new_size, qp)
            cost_small += process_block(enc, w, new_size, ypos + new_size,
                                        xpos + new_size, qp)

        if cost <= cost_small:
            # Children's reconstruction (bottom-up or top-down trial) is
            # simply overwritten by the final encode; when the children
            # win, their recon and deblock data stay in place (the
            # reference keeps rec_block local to each level, so nothing
            # needs undoing there).
            w.restore(stream_pos_ref)
            enc.final_encode = True
            encode_block(enc, w, binfo, binfo.block_param)
            enc.final_encode = False
            enc.store_deblock_data(binfo)
    elif encode_rectangular_size:
        cost = mode_decision_rdo(enc, w, binfo)
        if cost <= cost_small:
            w.restore(stream_pos_ref)
            binfo.block_param.mode = MODE_SKIP
            binfo.block_param.tb_param = 0
            encode_block(enc, w, binfo, binfo.block_param)
            enc.store_deblock_data(binfo)

    return min(cost, cost_small)
