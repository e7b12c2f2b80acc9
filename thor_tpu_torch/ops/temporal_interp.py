"""Temporal frame interpolation on the host (synthesized reference
frames), a copy of thor_tpu/ops/temporal_interp.py for the numpy decode
backend.

Exact port of common/temporal_interp.c:972-1053: a 4-level pyramid of
2x2 box-downscaled frames, per-16x16 bidirectional symmetric motion
estimation with candidate lists + skip test + adaptive cross search,
coarse-to-fine MV guides, a per-8x8 merge smoothing pass, and averaged
bidirectional motion compensation. Encoder and decoder run it identically
(the decoder re-synthesizes the interpolated reference,
dec/decode_frame.c:91-109), so it must be bit-exact.

interpolate_frames runs the C copy (native/thor_interp.c) by default; the
Python body below is its oracle (tests/test_torch_decode_np.py). The
device route synthesizes the same frame with kernels 3-5 (ops/interp.py).
"""

from __future__ import annotations

import numpy as np

BLOCK_STEP = 16
MAX_CANDS = 20
COST_MAX = 0x3FFFFFFF
LAMBDA = (3000 * BLOCK_STEP) // 16
LAMBDA_SHIFT = 4
SKIP_THRESHOLD = 8
ACC_BITS = 3
ACC_ROUND = 1 << (ACC_BITS - 1)
MAX_LEVELS = 4


class _Level:
    """One pyramid level: padded luma (+chroma at level 0) planes."""

    def __init__(self, y, pad, width, height, u=None, v=None, pad_c=0):
        self.y = y          # padded plane, origin at [pad, pad]
        self.pad = pad
        self.width = width
        self.height = height
        self.u = u
        self.v = v
        self.pad_c = pad_c

    def yat(self, r0, r1, c0, c1):
        p = self.pad
        return self.y[p + r0:p + r1, p + c0:p + c1]


def _scale_val(v, numer, denom):
    if denom == 0:
        return 0
    prod = v * numer
    if denom < 0:
        denom, prod = -denom, -prod
    if prod >= 0:
        return (prod + denom // 2) // denom
    return -((-prod + denom // 2) // denom)


def _scale_mv(mv, numer, denom):
    if numer == denom:
        return mv
    if numer == -denom:
        return (-mv[0], -mv[1])
    return (_scale_val(mv[0], numer, denom), _scale_val(mv[1], numer, denom))


def _downscale2x2(level: _Level, pad: int) -> _Level:
    """scale_frame_down2x2 (common/temporal_interp.c:151-245), luma only
    (the reference SIMD build never scales chroma and nothing reads it)."""
    w, h = level.width >> 1, level.height >> 1
    src = level.yat(0, 2 * h, 0, 2 * w).astype(np.int32)
    col = (src[0::2] + src[1::2] + 1) >> 1
    out = ((col[:, 0::2] + col[:, 1::2]) >> 1).astype(np.uint8)
    return _Level(np.pad(out, pad, mode="edge"), pad, w, h)


def _mv_absdist_filter(mlist):
    best_idx, best_cost = 0, COST_MAX
    for j, mj in enumerate(mlist):
        cost = sum(abs(mi[0] - mj[0]) + abs(mi[1] - mj[1]) for mi in mlist)
        if cost <= best_cost:
            best_idx, best_cost = j, cost
    return mlist[best_idx]


class _MvData:
    def __init__(self, w, h, bs, bbs, ratio, k):
        self.step = bbs // bs
        self.bw = self.step * ((w + bbs - 1) // bbs)
        self.bh = self.step * ((h + bbs - 1) // bbs)
        self.bbs, self.bs = bbs, bs
        self.skip_thr = SKIP_THRESHOLD
        self.skip_mv = (0, 0)
        self.scaled_skip_mv = (0, 0)
        self.mv0 = [(0, 0)] * (self.bw * self.bh)
        self.mv1 = [(0, 0)] * (self.bw * self.bh)
        self.bgmap = [0] * (self.bw * self.bh)
        self.ratio = ratio
        self.reversed = k > ratio // 2
        self.wt = [k if self.reversed else ratio - k, 0]
        self.wt[1] = ratio - self.wt[0]
        self.pos = k


def _sad(pic0: _Level, pic1: _Level, xs0, ys0, xs1, ys1, size):
    """sad_cost body (common/temporal_interp.c:443-523)."""
    pad = pic0.pad
    wP, hP = pic0.width + pad, pic0.height + pad
    if (xs0 >= -pad and xs0 + size <= wP and ys0 >= -pad and ys0 + size <= hP
            and xs1 >= -pad and xs1 + size <= wP and ys1 >= -pad and ys1 + size <= hP):
        a = pic0.yat(ys0, ys0 + size, xs0, xs0 + size).astype(np.int32)
        b = pic1.yat(ys1, ys1 + size, xs1, xs1 + size).astype(np.int32)
        return int(np.abs(a - b).sum())
    # clipped version
    i = np.arange(size)
    y0 = np.clip(i + ys0, -pad, hP - 1)[:, None]
    x0 = np.clip(i + xs0, -pad, wP - 1)[None, :]
    y1 = np.clip(i + ys1, -pad, hP - 1)[:, None]
    x1 = np.clip(i + xs1, -pad, wP - 1)[None, :]
    p = pic0.pad
    a = pic0.y[p + y0, p + x0].astype(np.int32)
    b = pic1.y[p + y1, p + x1].astype(np.int32)
    return int(np.abs(a - b).sum())


def _sad_cost(xstart, ystart, pic0, pic1, mv0, mv1, size, cost_start):
    xs0 = xstart + ((mv0[0] + ACC_ROUND) >> ACC_BITS)
    xs1 = xstart + ((mv1[0] + ACC_ROUND) >> ACC_BITS)
    ys0 = ystart + ((mv0[1] + ACC_ROUND) >> ACC_BITS)
    ys1 = ystart + ((mv1[1] + ACC_ROUND) >> ACC_BITS)
    return cost_start + _sad(pic0, pic1, xs0, ys0, xs1, ys1, size)


def _get_mv_cost(mv, md: _MvData, xp, yp, xs, ys, lam):
    bw, arr = md.bw, md.mv1
    diff = 0
    if xp == 0 and yp == 0:
        diff = 0
    elif yp > 0 and xp > 0 and xp < bw - xs:
        for p in ((yp - ys) * bw + xp + xs, (yp - ys) * bw + xp,
                  (yp - ys) * bw + xp - xs, yp * bw + xp - xs):
            diff += abs(mv[0] - arr[p][0]) + abs(mv[1] - arr[p][1])
    elif yp == 0:
        p = xp - xs
        diff = abs(mv[0] - arr[p][0]) + abs(mv[1] - arr[p][1])
    elif xp == 0:
        for p in ((yp - ys) * bw + xp + xs, (yp - ys) * bw + xp):
            diff += abs(mv[0] - arr[p][0]) + abs(mv[1] - arr[p][1])
    return (diff * lam) >> (LAMBDA_SHIFT + ACC_BITS)


def _add_cand(lst, max_c, cand):
    if len(lst) < max_c:
        if cand in lst:
            return
        lst.append(cand)


def _get_cands(md: _MvData, guides, xp, yp, xstep, ystep):
    lst = []
    pos = yp * md.bw + xp
    _add_cand(lst, MAX_CANDS, (0, 0))
    for g in guides:
        numer = md.wt[0] if md.reversed == g.reversed else -md.wt[0]
        _add_cand(lst, MAX_CANDS, _scale_mv(g.mv1[pos], numer, g.wt[0]))
    if yp > 0 and xp < md.bw - xstep:
        _add_cand(lst, MAX_CANDS, md.mv1[(yp - ystep) * md.bw + xp + xstep])
    if xp > 0:
        _add_cand(lst, MAX_CANDS, md.mv1[yp * md.bw + xp - xstep])
    if yp > 0:
        _add_cand(lst, MAX_CANDS, md.mv1[(yp - ystep) * md.bw + xp])
    return lst


def _get_merge_cands(md: _MvData, xp, yp):
    lst = []
    yoff = 2 if (yp & 1) else 1
    xoff = 2 if (yp & 1) else 1  # sic: the reference keys xoff on yp too
    _add_cand(lst, MAX_CANDS, md.mv1[yp * md.bw + xp])
    if yp - yoff >= 0:
        _add_cand(lst, MAX_CANDS, md.mv1[(yp - yoff) * md.bw + xp])
    if yp + yoff < md.bh:
        _add_cand(lst, MAX_CANDS, md.mv1[(yp + yoff) * md.bw + xp])
    if xp - xoff >= 0:
        _add_cand(lst, MAX_CANDS, md.mv1[yp * md.bw + xp - xoff])
    if xp + xoff < md.bw:
        _add_cand(lst, MAX_CANDS, md.mv1[yp * md.bw + xp + xoff])
    return lst


def _make_skip_vector(md: _MvData, xp, yp, xstep, ystep):
    bw = md.bw
    vlist = []
    if yp > 0 and xp < bw - xstep:
        vlist.append(md.mv1[(yp - ystep) * bw + xp + xstep])
    if xp > 0:
        vlist.append(md.mv1[yp * bw + xp - xstep])
    if yp > 0:
        vlist.append(md.mv1[(yp - ystep) * bw + xp])
    md.skip_mv = _mv_absdist_filter(vlist) if vlist else (0, 0)
    md.scaled_skip_mv = _scale_mv(md.skip_mv, -md.wt[1], md.wt[0])


def _skip_test(md: _MvData, pic0: _Level, pic1: _Level, xp, yp):
    """common/temporal_interp.c:525-647"""
    xstart, ystart = xp * md.bs, yp * md.bs
    mv1, mv0 = md.skip_mv, md.scaled_skip_mv
    pos = yp * md.bw + xp
    size = md.bbs
    thr = md.skip_thr * 8 * 8
    pad = pic0.pad
    hP, wP = pic0.height + pad, pic0.width + pad
    skip = True
    for p in range(ystart, ystart + size, 8):
        if not skip:
            break
        for q in range(xstart, xstart + size, 8):
            xs0 = q + ((mv0[0] + ACC_ROUND) >> ACC_BITS)
            xs1 = q + ((mv1[0] + ACC_ROUND) >> ACC_BITS)
            ys0 = p + ((mv0[1] + ACC_ROUND) >> ACC_BITS)
            ys1 = p + ((mv1[1] + ACC_ROUND) >> ACC_BITS)
            if (xs0 >= -pad and xs0 + 8 <= wP and ys0 >= -pad and ys0 + 8 <= hP
                    and xs1 >= -pad and xs1 + 8 <= wP and ys1 >= -pad and ys1 + 8 <= hP):
                a = pic0.yat(ys0, ys0 + 8, xs0, xs0 + 8).astype(np.int32)
                b = pic1.yat(ys1, ys1 + 8, xs1, xs1 + 8).astype(np.int32)
                if np.abs(a - b).sum() > thr:
                    skip = False
                    break
            else:
                skip = False
                break
    if skip:
        md.bgmap[pos] = 1
        md.mv1[pos] = md.skip_mv
        md.mv0[pos] = md.scaled_skip_mv
    bw = md.bw
    for off in (1, bw, bw + 1):
        md.mv0[pos + off] = md.mv0[pos]
        md.mv1[pos + off] = md.mv1[pos]
        md.bgmap[pos + off] = md.bgmap[pos]


def _adaptive_search(md: _MvData, guided, cands, pic0, pic1, xp, yp,
                     xstep, ystep):
    """common/temporal_interp.c:650-725"""
    xstart, ystart = xp * md.bs, yp * md.bs
    size = md.bbs
    best_mv = cands[0]
    best_scaled = _scale_mv(best_mv, -md.wt[1], md.wt[0])
    best_cost = COST_MAX
    lam = LAMBDA // 4 if guided else LAMBDA

    for c, cand in enumerate(cands):
        mv1 = cand
        mv0 = _scale_mv(cand, -md.wt[1], md.wt[0])
        cost = _get_mv_cost(cand, md, xp, yp, xstep, ystep, lam)
        cost = _sad_cost(xstart, ystart, pic0, pic1, mv0, mv1, size, cost)
        ref_mv, ref_scaled = mv1, mv0

        if ((4 + c) * cost) // 8 < best_cost:
            shift = (0 if guided else 3) + ACC_BITS
            count = 8 if guided else 64
            while shift >= ACC_BITS and count > 0:
                off = 1 << shift
                better = False
                for rmv in ((ref_mv[0] - off, ref_mv[1]),
                            (ref_mv[0] + off, ref_mv[1]),
                            (ref_mv[0], ref_mv[1] - off),
                            (ref_mv[0], ref_mv[1] + off)):
                    m0 = _scale_mv(rmv, -md.wt[1], md.wt[0])
                    bcost = _get_mv_cost(rmv, md, xp, yp, xstep, ystep, lam)
                    bcost = _sad_cost(xstart, ystart, pic0, pic1, m0, rmv,
                                      size, bcost)
                    if bcost < cost:
                        cost, ref_mv, ref_scaled = bcost, rmv, m0
                        better = True
                if not better:
                    shift -= 1
                count -= 4
        if cost < best_cost:
            best_mv, best_scaled, best_cost = ref_mv, ref_scaled, cost

    pos = yp * md.bw + xp
    md.mv1[pos] = best_mv
    md.mv0[pos] = best_scaled


def _motion_estimate_bi(md: _MvData, guides, in0: _Level, in1: _Level):
    """common/temporal_interp.c:852-918"""
    bw, bh, step = md.bw, md.bh, md.step
    if not guides:
        md.mv0 = [(0, 0)] * (bw * bh)
        md.mv1 = [(0, 0)] * (bw * bh)
    md.bgmap = [0] * (bw * bh)

    pic0 = in1 if md.reversed else in0
    pic1 = in0 if md.reversed else in1

    for i in range(0, bh, step):
        for j in range(0, bw, step):
            _make_skip_vector(md, j, i, step, step)
            _skip_test(md, pic0, pic1, j, i)
            pos = i * bw + j
            if md.bgmap[pos] == 0:
                cands = _get_cands(md, guides, j, i, step, step)
                _adaptive_search(md, bool(guides), cands, pic0, pic1, j, i,
                                 step, step)
            mv0, mv1, bg = md.mv0[pos], md.mv1[pos], md.bgmap[pos]
            for q in range(step):
                for p in range(step):
                    md.mv0[pos + q * bw + p] = mv0
                    md.mv1[pos + q * bw + p] = mv1
                    md.bgmap[pos + q * bw + p] = bg

    # merge smoothing pass on 8x8 cells
    nmv0 = list(md.mv0)
    nmv1 = list(md.mv1)
    for i in range(bh):
        for j in range(bw):
            cands = _get_merge_cands(md, j, i)
            if len(cands) > 1:
                best_cost, best_mv, best_scaled = COST_MAX, (0, 0), (0, 0)
                for rmv in cands:
                    m0 = _scale_mv(rmv, -md.wt[1], md.wt[0])
                    c = _sad_cost(j * md.bs, i * md.bs, pic0, pic1, m0, rmv,
                                  md.bs, 0)
                    if c < best_cost:
                        best_cost, best_mv, best_scaled = c, rmv, m0
                nmv1[i * bw + j] = best_mv
                nmv0[i * bw + j] = best_scaled
    md.mv0, md.mv1 = nmv0, nmv1


def _mot_comp_avg(xstart, ystart, r0, s0pad, r1, s1pad, out, opad, mv0, mv1,
                  wP, hP, pad, size):
    """common/temporal_interp.c:387-441. r0/r1/out are padded planes."""
    xs0 = xstart + ((mv0[0] + ACC_ROUND) >> ACC_BITS)
    xs1 = xstart + ((mv1[0] + ACC_ROUND) >> ACC_BITS)
    ys0 = ystart + ((mv0[1] + ACC_ROUND) >> ACC_BITS)
    ys1 = ystart + ((mv1[1] + ACC_ROUND) >> ACC_BITS)

    in0 = (xs0 >= -pad and xs0 + size <= wP and ys0 >= -pad and ys0 + size <= hP)
    in1 = (xs1 >= -pad and xs1 + size <= wP and ys1 >= -pad and ys1 + size <= hP)

    dst = out[opad + ystart:opad + ystart + size,
              opad + xstart:opad + xstart + size]
    if in0 and in1:
        a = r0[s0pad + ys0:s0pad + ys0 + size, s0pad + xs0:s0pad + xs0 + size].astype(np.int32)
        b = r1[s1pad + ys1:s1pad + ys1 + size, s1pad + xs1:s1pad + xs1 + size].astype(np.int32)
        dst[:] = ((a + b + 1) // 2).astype(np.uint8)
    elif in1:
        dst[:] = r1[s1pad + ys1:s1pad + ys1 + size, s1pad + xs1:s1pad + xs1 + size]
    elif in0:
        dst[:] = r0[s0pad + ys0:s0pad + ys0 + size, s0pad + xs0:s0pad + xs0 + size]
    else:
        i = np.arange(size)
        y0 = np.clip(i + ys0, -pad, hP - 1)[:, None]
        x0 = np.clip(i + xs0, -pad, wP - 1)[None, :]
        y1 = np.clip(i + ys1, -pad, hP - 1)[:, None]
        x1 = np.clip(i + xs1, -pad, wP - 1)[None, :]
        a = r0[s0pad + y0, s0pad + x0].astype(np.int32)
        b = r1[s1pad + y1, s1pad + x1].astype(np.int32)
        dst[:] = ((a + b + 1) // 2).astype(np.uint8)


def interpolate_frames(ref0, ref1, ratio: int, pos: int,
                       native: bool = True):
    """common/temporal_interp.c:972-1053.

    ref0/ref1: RefFrame-like with padded .y/.u/.v (pads 96/48).
    Returns unpadded (y, u, v) planes of the synthesized frame.

    native=True runs the C copy (native/thor_interp.c); a failure to
    build or load it raises. native=False runs the Python body below,
    the C copy's oracle.
    """
    if native:
        from ..native import interpolate_frames_native
        return interpolate_frames_native(ref0, ref1, ratio, pos)
    PAD_Y, PAD_C = 96, 48
    h, w = ref0.y.shape[0] - 2 * PAD_Y, ref0.y.shape[1] - 2 * PAD_Y
    import math
    max_levels = min(MAX_LEVELS,
                     int(math.log10(min(w, h)) / math.log10(2.0) - 4.0))

    lv0_0 = _Level(ref0.y, PAD_Y, w, h, ref0.u, ref0.v, PAD_C)
    lv0_1 = _Level(ref1.y, PAD_Y, w, h, ref1.u, ref1.v, PAD_C)
    levels0, levels1 = [lv0_0], [lv0_1]
    for l in range(max_levels - 1):
        levels0.append(_downscale2x2(levels0[-1], 32))
        levels1.append(_downscale2x2(levels1[-1], 32))

    mds = [_MvData(w >> j, h >> j, BLOCK_STEP // 2, BLOCK_STEP, ratio, pos)
           for j in range(max_levels)]
    spatial = [_MvData(w >> j, h >> j, BLOCK_STEP // 2, BLOCK_STEP, ratio, pos)
               for j in range(max_levels)]

    out_y = out_u = out_v = None
    for lvl in range(max_levels - 1, -1, -1):
        guides = [] if lvl == max_levels - 1 else [spatial[lvl]]
        _motion_estimate_bi(mds[lvl], guides, levels0[lvl], levels1[lvl])
        if lvl == 0:
            out_y, out_u, out_v = _interpolate_frame(
                mds[0], levels0[0], levels1[0], w, h)
        if lvl > 0:
            _upscale_mv(mds[lvl], spatial[lvl - 1])
    return out_y, out_u, out_v


def _upscale_mv(md_in: _MvData, md_out: _MvData):
    """common/temporal_interp.c:247-271"""
    bwo, bho, bwi = md_out.bw, md_out.bh, md_in.bw
    for i in range(bho):
        for j in range(bwo):
            po = i * bwo + j
            pi = (i // 2) * bwi + (j // 2)
            mv1 = (md_in.mv1[pi][0] * 2, md_in.mv1[pi][1] * 2)
            md_out.mv1[po] = mv1
            md_out.mv0[po] = _scale_mv(mv1, -md_out.wt[1], md_out.wt[0])


def _interpolate_frame(md: _MvData, in0: _Level, in1: _Level, w, h):
    """common/temporal_interp.c:920-970 (pad=bs/2=4)."""
    pic0 = in1 if md.reversed else in0
    pic1 = in0 if md.reversed else in1
    bs = md.bs
    pad = bs // 2
    wP, hP = w + pad, h + pad
    wPc, hPc, padc = wP // 2, hP // 2, pad // 2

    # output padded planes (pad must cover the overshoot rows/cols the
    # block grid writes past the frame edge)
    opad_y, opad_c = 96, 48
    oy = np.zeros((h + 2 * opad_y, w + 2 * opad_y), np.uint8)
    ou = np.zeros((h // 2 + 2 * opad_c, w // 2 + 2 * opad_c), np.uint8)
    ov = np.zeros((h // 2 + 2 * opad_c, w // 2 + 2 * opad_c), np.uint8)

    for yp in range(md.bh):
        for xp in range(md.bw):
            mv0 = md.mv0[yp * md.bw + xp]
            mv1 = md.mv1[yp * md.bw + xp]
            _mot_comp_avg(xp * bs, yp * bs, pic0.y, pic0.pad, pic1.y,
                          pic1.pad, oy, opad_y, mv0, mv1, wP, hP, pad, bs)
            cmv1 = (mv1[0] >> 1, mv1[1] >> 1)
            cmv0 = _scale_mv(cmv1, -md.wt[1], md.wt[0])
            bsc = bs // 2
            _mot_comp_avg(xp * bsc, yp * bsc, pic0.u, pic0.pad_c, pic1.u,
                          pic1.pad_c, ou, opad_c, cmv0, cmv1, wPc, hPc, padc, bsc)
            _mot_comp_avg(xp * bsc, yp * bsc, pic0.v, pic0.pad_c, pic1.v,
                          pic1.pad_c, ov, opad_c, cmv0, cmv1, wPc, hPc, padc, bsc)

    return (oy[opad_y:opad_y + h, opad_y:opad_y + w],
            ou[opad_c:opad_c + h // 2, opad_c:opad_c + w // 2],
            ov[opad_c:opad_c + h // 2, opad_c:opad_c + w // 2])
