"""Frame level of the host mirror encoder (device_encode=0).

Counterpart of the host half of thor_tpu/enc/encoder.py: the superblock
raster loop with its delta-QP trial, the inter block encode, the early
skip search and the persistent ME candidate state of the reference RD
search (enc/encode_frame.c, enc/encode_block.c). The search is serial per
block over 4x4 to 64x64 arrays, so it stays numpy on the host, as in
thor_tpu: its working planes (the original, the reconstruction) are numpy
and each reference it reads is the host copy of a padded reference
(HostRef). The frame's in-loop filters, the reference window and the
interpolated reference live on the encoder's device (enc/encoder.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..bitstream.writer import BitWriter
from ..codec.constants import (
    CHROMA_QP, GQUANT_TABLE, I_FRAME, MAX_BLOCK_SIZE, MODE_BIPRED,
    MODE_INTER, MODE_MERGE, MODE_SKIP, PAD_C, PAD_Y, log2i)
from ..ops import np_kernels as K
from .block import BlockParam, _copy_param, cost_calc, encode_block, \
    process_block
from .inter import MVCandList, clip_mv
from .quant import quantize


@dataclass
class HostRef:
    """The host copy of a padded reference: uint8 numpy planes, padded by
    96 (luma) / 48 (chroma) exactly as np_kernels.pad_plane pads them,
    and the display number."""
    y: np.ndarray
    u: np.ndarray
    v: np.ndarray
    frame_num: int


class HostMirror:
    """The host mirror search of one Encoder. It keeps the state the
    reference keeps across blocks and frames: the per-reference ME
    candidate lists (their slots persist across superblocks; each
    superblock resets only counts and masks), best_ref and final_encode.
    Every other attribute (frame type, QP, lambda, references, the
    deblocking side info, the parameters) is read from the encoder."""

    def __init__(self, enc):
        self.enc = enc
        self.mvcand = {}
        self.best_ref = -1
        self.final_encode = False
        self.org_y = self.org_u = self.org_v = None
        self.rec_y = self.rec_u = self.rec_v = None

    def __getattr__(self, name):
        return getattr(self.enc, name)

    def get_ref(self, ref_idx):
        return self.enc.get_ref(ref_idx).host()

    def encode_frame(self, w: BitWriter):
        """The superblock raster loop of encode_frame (enc/encode_frame.c,
        thor_tpu/enc/encoder.py:629-648) over the encoder's current
        frame, with the delta-QP trial of each superblock. The
        reconstruction starts from the encoder's last one (zeros before
        the first frame), as the reference's frame buffer does. Returns
        the unfiltered (y, u, v) uint8 planes."""
        enc, p = self.enc, self.enc.params
        self.org_y, self.org_u, self.org_v = (
            t.cpu().numpy() for t in (enc.org_y, enc.org_u, enc.org_v))
        if enc.rec_y is None:
            self.rec_y = np.zeros_like(self.org_y)
            self.rec_u = np.zeros_like(self.org_u)
            self.rec_v = np.zeros_like(self.org_v)
        else:
            self.rec_y, self.rec_u, self.rec_v = (
                t.cpu().numpy().copy() for t in (enc.rec_y, enc.rec_u,
                                                 enc.rec_v))
        num_sb_hor = (enc.width + MAX_BLOCK_SIZE - 1) // MAX_BLOCK_SIZE
        num_sb_ver = (enc.height + MAX_BLOCK_SIZE - 1) // MAX_BLOCK_SIZE
        for k in range(num_sb_ver):
            for l in range(num_sb_hor):
                self.reset_sb_state()
                ypos, xpos = k * MAX_BLOCK_SIZE, l * MAX_BLOCK_SIZE
                if p.max_delta_qp:
                    pos = w.save()
                    min_cost, best_qp = 1 << 30, enc.frame_qp
                    for qp0 in range(enc.frame_qp - p.max_delta_qp,
                                     enc.frame_qp + p.max_delta_qp + 1,
                                     p.delta_qp_step):
                        cost = process_block(self, w, MAX_BLOCK_SIZE,
                                             ypos, xpos, qp0)
                        if cost < min_cost:
                            min_cost, best_qp = cost, qp0
                    w.restore(pos)
                    process_block(self, w, MAX_BLOCK_SIZE, ypos, xpos,
                                  best_qp)
                else:
                    process_block(self, w, MAX_BLOCK_SIZE, ypos, xpos,
                                  enc.frame_qp)
        return self.rec_y, self.rec_u, self.rec_v

    def reset_sb_state(self):
        """Per-SB ME candidate reset (enc/encode_frame.c:117-122):
        counts and masks reset, slot contents persist like the
        reference's fixed arrays."""
        for cl in self.mvcand.values():
            cl.reset()
        self.best_ref = -1

    def mvcand_for(self, ref_idx):
        if ref_idx not in self.mvcand:
            self.mvcand[ref_idx] = MVCandList()
        return self.mvcand[ref_idx]

    # --- hooks used by block.py ---

    def save_region(self, binfo):
        y0, x0 = binfo.ypos, binfo.xpos
        yc, xc = y0 // 2, x0 // 2
        bh, bw = binfo.bheight, binfo.bwidth
        return (self.rec_y[y0:y0+bh, x0:x0+bw].copy(),
                self.rec_u[yc:yc+(bh+1)//2, xc:xc+(bw+1)//2].copy(),
                self.rec_v[yc:yc+(bh+1)//2, xc:xc+(bw+1)//2].copy())

    def restore_region(self, binfo, region):
        y0, x0 = binfo.ypos, binfo.xpos
        yc, xc = y0 // 2, x0 // 2
        bh, bw = binfo.bheight, binfo.bwidth
        self.rec_y[y0:y0+bh, x0:x0+bw] = region[0]
        self.rec_u[yc:yc+(bh+1)//2, xc:xc+(bw+1)//2] = region[1]
        self.rec_v[yc:yc+(bh+1)//2, xc:xc+(bw+1)//2] = region[2]

    def _pred_yuv(self, ref, binfo, mv_arr, sign, split):
        """get_inter_prediction_yuv (enc/encode_block.c:1534-1567):
        per-PB MC with MV clipping; returns (py, pu, pv) covering
        bwidth x bheight."""
        div = split + 1
        bw, bh = binfo.bwidth // div, binfo.bheight // div
        size = binfo.size
        ypos, xpos = binfo.ypos, binfo.xpos
        py = np.empty((binfo.bheight, binfo.bwidth), np.uint8)
        pu = np.empty((binfo.bheight // 2, binfo.bwidth // 2), np.uint8)
        pv = np.empty_like(pu)
        eb = self.enable_bipred
        for index in range(div * div):
            idx, idy = index & 1, (index >> 1) & 1
            mvx, mvy = clip_mv(mv_arr[index][0], mv_arr[index][1], ypos,
                               xpos, self.width, self.height, size, sign)
            oy, ox = ypos + idy * bh, xpos + idx * bw
            py[idy*bh:(idy+1)*bh, idx*bw:(idx+1)*bw] = K.mc_luma(
                ref.y, PAD_Y + oy, PAD_Y + ox, bh, bw, mvx, mvy, sign, eb)
            oyc, oxc = ypos // 2 + idy * bh // 2, xpos // 2 + idx * bw // 2
            pu[idy*bh//2:(idy+1)*bh//2, idx*bw//2:(idx+1)*bw//2] = \
                K.mc_chroma(ref.u, PAD_C + oyc, PAD_C + oxc, bh // 2,
                            bw // 2, mvx, mvy, sign)
            pv[idy*bh//2:(idy+1)*bh//2, idx*bw//2:(idx+1)*bw//2] = \
                K.mc_chroma(ref.v, PAD_C + oyc, PAD_C + oxc, bh // 2,
                            bw // 2, mvx, mvy, sign)
        return py, pu, pv

    @staticmethod
    def _avg_pred(p0, p1):
        return tuple(((a.astype(np.int32) + b) >> 1).astype(np.uint8)
                     for a, b in zip(p0, p1))

    def _inter_residual_plane(self, org, pred, size, qp, coeff_type,
                              tb_split):
        """encode_and_reconstruct_block_inter for one plane
        (enc/encode_block.c:1469-1532). Returns (cbp, coeffq, rec)."""
        p = self.params
        resid = org.astype(np.int16) - pred.astype(np.int16)
        coeffq = np.zeros((size, size), np.int16)
        if tb_split:
            s2 = size // 2
            cbp = 0
            rblock = np.zeros((size, size), np.int16)
            for i in (0, s2):
                for j in (0, s2):
                    fast = size == 64 or p.encoder_speed > 1
                    coeff = K.transform_fwd(
                        np.ascontiguousarray(resid[i:i+s2, j:j+s2]), s2,
                        fast)
                    cbpbit, cq = quantize(coeff, qp, s2, coeff_type,
                                          p.rdoq)
                    if cbpbit:
                        rblock[i:i+s2, j:j+s2] = K.inverse_transform(
                            K.dequantize(cq, qp), s2)
                    coeffq[i:i+s2, j:j+s2] = cq
                    cbp = (cbp << 1) + cbpbit
            rec = K.reconstruct_block(rblock, pred)
            return cbp, coeffq, rec
        fast = (size == 64 and p.encoder_speed > 0) or p.encoder_speed > 1
        coeff = K.transform_fwd(resid, size, fast)
        cbp, coeffq = quantize(coeff, qp, size, coeff_type, p.rdoq)
        if cbp:
            rec = K.reconstruct_block(
                K.inverse_transform(K.dequantize(coeffq, qp), size), pred)
        else:
            rec = pred.copy()
        return cbp, coeffq, rec

    def encode_inter_block(self, w, binfo, bp, qpY, qpC):
        """Pixel path of encode_block for non-intra modes
        (enc/encode_block.c:1688-1790). Writes recon into the frame rec
        planes; sets bp.cbp / coefficient planes."""
        mode = bp.mode
        ypos, xpos = binfo.ypos, binfo.xpos
        bw, bh = binfo.bwidth, binfo.bheight
        yc, xc = ypos // 2, xpos // 2
        split = self.params.enable_pb_split if mode in (MODE_INTER,
                                                        MODE_BIPRED) else 0

        if mode == MODE_SKIP or mode == MODE_MERGE:
            if bp.dir == 2:
                ref0 = self.get_ref(bp.ref_idx0)
                ref1 = self.get_ref(bp.ref_idx1)
                s0 = 1 if ref0.frame_num >= self.frame_num else 0
                s1 = 1 if ref1.frame_num >= self.frame_num else 0
                pred = self._avg_pred(
                    self._pred_yuv(ref0, binfo, bp.mv_arr0, s0, 0),
                    self._pred_yuv(ref1, binfo, bp.mv_arr1, s1, 0))
            else:
                ref0 = self.get_ref(bp.ref_idx0)
                s0 = 1 if ref0.frame_num > self.frame_num else 0
                pred = self._pred_yuv(ref0, binfo, bp.mv_arr0, s0, 0)
        elif mode == MODE_INTER:
            ref0 = self.get_ref(bp.ref_idx0)
            s0 = 1 if ref0.frame_num > self.frame_num else 0
            pred = self._pred_yuv(ref0, binfo, bp.mv_arr0, s0, split)
        else:  # MODE_BIPRED
            ref0 = self.get_ref(bp.ref_idx0)
            ref1 = self.get_ref(bp.ref_idx1)
            s0 = 1 if ref0.frame_num >= self.frame_num else 0
            s1 = 1 if ref1.frame_num >= self.frame_num else 0
            pred = self._avg_pred(
                self._pred_yuv(ref0, binfo, bp.mv_arr0, s0, split),
                self._pred_yuv(ref1, binfo, bp.mv_arr1, s1, split))

        if mode == MODE_SKIP:
            bp.cbp = (0, 0, 0)
            self.rec_y[ypos:ypos+bh, xpos:xpos+bw] = pred[0]
            self.rec_u[yc:yc+bh//2, xc:xc+bw//2] = pred[1]
            self.rec_v[yc:yc+bh//2, xc:xc+bw//2] = pred[2]
            return

        size = binfo.size
        sc = size // 2
        if bp.tb_param == -1:
            bp.cbp = (0, 0, 0)
            recs = pred
        else:
            it = (1 if self.frame_type == I_FRAME else 0) << 1
            tb = bp.tb_split
            cy, bp.coeff_y, ry = self._inter_residual_plane(
                self.org_y[ypos:ypos+size, xpos:xpos+size], pred[0],
                size, qpY, it | 0, tb)
            cu, bp.coeff_u, ru = self._inter_residual_plane(
                self.org_u[yc:yc+sc, xc:xc+sc], pred[1], sc, qpC,
                it | 1, tb and size > 8)
            cv, bp.coeff_v, rv = self._inter_residual_plane(
                self.org_v[yc:yc+sc, xc:xc+sc], pred[2], sc, qpC,
                it | 1, tb and size > 8)
            bp.cbp = (cy, cu, cv)
            recs = (ry, ru, rv)
        self.rec_y[ypos:ypos+size, xpos:xpos+size] = recs[0]
        self.rec_u[yc:yc+sc, xc:xc+sc] = recs[1]
        self.rec_v[yc:yc+sc, xc:xc+sc] = recs[2]

    # --- early skip (enc/encode_block.c:2481-2783) ---

    def _early_skip_threshold(self, size):
        """float32 semantics throughout: early_skip_threshold is a C
        float, including after the 1.3x scaling for 64-blocks
        (enc/encode_block.c:2635-2636)."""
        thr = float(np.float32(self.params.early_skip_thr))
        if self.params.encoder_speed > 1 and size == MAX_BLOCK_SIZE:
            thr = float(np.float32(1.3 * thr))
        return thr

    @staticmethod
    def _check_sub_luma(org, pred, size, qp, thr):
        """check_early_skip_sub_block (enc/encode_block.c:2505-2538)."""
        resid = org.astype(np.int32) - pred.astype(np.int32)
        if size > 4:
            s2 = size // 2
            tmp = ((resid.reshape(s2, 2, s2, 2).transpose(0, 2, 1, 3)
                    .reshape(s2, s2, 4).sum(axis=2) + 2) >> 2) \
                .astype(np.int16)
            coeff = K.transform_fwd(tmp, s2, False)
            tsize, rel = s2, 0.5 * thr
        else:
            coeff = K.transform_fwd(resid.astype(np.int16), size, False)
            tsize, rel = size, thr
        shift2 = 21 - log2i(tsize) + qp // 6
        first_level = float(1 << shift2) / float(GQUANT_TABLE[qp % 6])
        threshold = int(rel * first_level)
        return bool((np.abs(coeff[:tsize, :tsize]) > threshold).any())

    @staticmethod
    def _check_sub_chroma(org, pred, size, qp, thr):
        """check_early_skip_sub_blockC (enc/encode_block.c:2540-2611):
        column-sum significance (SIMD-path semantics: per-column sums for
        size 8, col-pair sums of the first 4 rows/cols otherwise)."""
        shift2 = 21 - 5 + qp // 6
        threshold = int(thr * (float(1 << shift2)
                               / float(GQUANT_TABLE[qp % 6])))
        resid = org.astype(np.int32) - pred.astype(np.int32)
        if size == 8:
            colsum = resid.sum(axis=0)
            return bool((colsum > threshold).any())
        c = resid[:4, :4].sum(axis=0)
        return bool(c[0] + c[1] > threshold or c[2] + c[3] > threshold)

    def _check_early_skip_block(self, binfo, bp):
        """check_early_skip_block (enc/encode_block.c:2613-2745).
        Returns True if the candidate is insignificant (skippable)."""
        size = binfo.size
        ypos, xpos = binfo.ypos, binfo.xpos
        size0 = min(size, 32)  # EARLY_SKIP_BLOCK_SIZE
        qpY = self.frame_qp + binfo.delta_qp
        qpC = int(CHROMA_QP[qpY])
        thr = self._early_skip_threshold(size)
        eb = self.enable_bipred
        PY, PC = PAD_Y, PAD_C
        significant = False

        if bp.dir == 2:
            ref0 = self.get_ref(bp.ref_idx0)
            ref1 = self.get_ref(bp.ref_idx1)
            s0 = 1 if ref0.frame_num >= self.frame_num else 0
            s1 = 1 if ref1.frame_num >= self.frame_num else 0
            for i in range(0, size, size0):
                for j in range(0, size, size0):
                    mv0 = clip_mv(bp.mv_arr0[0][0], bp.mv_arr0[0][1],
                                  ypos, xpos, self.width, self.height,
                                  size0, s0)
                    mv1 = clip_mv(bp.mv_arr1[0][0], bp.mv_arr1[0][1],
                                  ypos, xpos, self.width, self.height,
                                  size0, s1)
                    p0 = K.mc_luma(ref0.y, PY+ypos+i, PY+xpos+j, size0,
                                   size0, mv0[0], mv0[1], s0, eb)
                    p1 = K.mc_luma(ref1.y, PY+ypos+i, PY+xpos+j, size0,
                                   size0, mv1[0], mv1[1], s1, eb)
                    pb = ((p0.astype(np.int32) + p1) >> 1).astype(np.uint8)
                    o = self.org_y[ypos+i:ypos+i+size0, xpos+j:xpos+j+size0]
                    significant = significant or self._check_sub_luma(
                        o, pb, size0, qpY, thr)
                    # chroma uses the unclipped MVs (reference quirk)
                    for (plane, orgp) in ((0, self.org_u), (1, self.org_v)):
                        r0 = ref0.u if plane == 0 else ref0.v
                        r1 = ref1.u if plane == 0 else ref1.v
                        c0 = K.mc_chroma(r0, PC+(ypos+i)//2, PC+(xpos+j)//2,
                                         size0//2, size0//2,
                                         bp.mv_arr0[0][0], bp.mv_arr0[0][1],
                                         s0)
                        c1 = K.mc_chroma(r1, PC+(ypos+i)//2, PC+(xpos+j)//2,
                                         size0//2, size0//2,
                                         bp.mv_arr1[0][0], bp.mv_arr1[0][1],
                                         s1)
                        cb = ((c0.astype(np.int32) + c1) >> 1).astype(np.uint8)
                        oc = orgp[(ypos+i)//2:(ypos+i)//2+size0//2,
                                  (xpos+j)//2:(xpos+j)//2+size0//2]
                        significant = significant or self._check_sub_chroma(
                            oc, cb, size0//2, qpC, thr)
        else:
            ref = self.get_ref(bp.ref_idx0)
            sign = 1 if ref.frame_num > self.frame_num else 0
            mvx, mvy = bp.mv_arr0[0]
            for i in range(0, size, size0):
                for j in range(0, size, size0):
                    mvx, mvy = clip_mv(mvx, mvy, ypos, xpos, self.width,
                                       self.height, size0, sign)
                    pb = K.mc_luma(ref.y, PY+ypos+i, PY+xpos+j, size0,
                                   size0, mvx, mvy, sign, eb)
                    o = self.org_y[ypos+i:ypos+i+size0, xpos+j:xpos+j+size0]
                    significant = significant or self._check_sub_luma(
                        o, pb, size0, qpY, thr)
                    for (orgp, rp) in ((self.org_u, ref.u),
                                       (self.org_v, ref.v)):
                        cb = K.mc_chroma(rp, PC+(ypos+i)//2, PC+(xpos+j)//2,
                                         size0//2, size0//2, mvx, mvy, sign)
                        oc = orgp[(ypos+i)//2:(ypos+i)//2+size0//2,
                                  (xpos+j)//2:(xpos+j)//2+size0//2]
                        significant = significant or self._check_sub_chroma(
                            oc, cb, size0//2, qpC, thr)
        return not significant

    def search_early_skip(self, w, binfo):
        """search_early_skip_candidates (enc/encode_block.c:2747-2783)."""
        min_cost = (1 << 32) - 1
        early_skip_flag = 0
        for skip_idx, c in enumerate(binfo.skip_candidates):
            tmp = BlockParam(
                tb_param=0, skip_idx=skip_idx, ref_idx0=c.ref_idx0,
                ref_idx1=c.ref_idx1, dir=c.bipred_flag,
                mv_arr0=[(c.mv0x, c.mv0y)] * 4,
                mv_arr1=[(c.mv1x, c.mv1y)] * 4)
            if self._check_early_skip_block(binfo, tmp):
                early_skip_flag = 1
                tmp.mode = MODE_SKIP
                nbit = encode_block(self, w, binfo, tmp)
                cost = cost_calc(self, binfo, nbit)
                if cost < min_cost:
                    min_cost = cost
                    binfo.block_param = _copy_param(tmp)
        return early_skip_flag
