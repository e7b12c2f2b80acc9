"""Inter-frame search of the host mirror encoder: motion estimation,
MV candidates, inter prediction parameters.

Counterpart of thor_tpu/enc/inter.py, an exact behavioral mirror of the
reference search (cited per function). The SAD surfaces and the fast
sub-pel approximations are whole-block numpy expressions; the search
control flow is sequential, as in the reference.
"""

from __future__ import annotations

import numpy as np

from ..codec.constants import PAD_Y
from ..ops import np_kernels as K


def sad_calc(org, refwin):
    return int(np.abs(org.astype(np.int32) - refwin).sum())


def widesad_calc(org, refpad, by, bx, width, height):
    """Five-position x.xXx.x SAD (enc/enc_kernels.c:71, scalar model
    enc/encode_block.c:790-815). Returns (bestsad, bestx)."""
    best, bestx = 1 << 31, 0
    o = org.astype(np.int32)
    for off in (-3, -1, 0, 1, 3):
        s = int(np.abs(o - refpad[by:by + height,
                                  bx + off:bx + off + width]).sum())
        if s < best:
            best, bestx = s, off
    return best, bestx


def quote_mv_bits(mv_diff_y, mv_diff_x):
    """enc/encode_block.c:799-814: quote_vlc(10, 2|d| - (d < 0)) of each
    component, that is 1 + 2 log2(cn + 1)."""
    bits = 0
    for d in (mv_diff_x, mv_diff_y):
        bits += 2 * (2 * abs(d) - (1 if d < 0 else 0) + 1).bit_length() - 1
    return bits


def clip_mv(mvx, mvy, ypos, xpos, fwidth, fheight, size, sign):
    """enc/encode_block.c:816-828 (note the asymmetric x high clamp)."""
    ext = PAD_Y - 16
    y = -mvy if sign else mvy
    x = -mvx if sign else mvx
    if ypos + y // 4 < -ext:
        y = 4 * (-ext - ypos)
    if ypos + y // 4 + size > fheight + ext:
        y = 4 * (fheight + ext - ypos - size)
    if xpos + x // 4 < -ext:
        x = 4 * (-ext - xpos)
    if xpos + x // 4 > fwidth + ext:
        x = 4 * (fwidth + ext - xpos - size)
    return (-x if sign else x), (-y if sign else y)


def _avg(a, b):
    return (a + b + 1) >> 1


def sad_calc_fasthalf(org, refpad, by, bx, width, height):
    """8-position half-pel SAD via bilinear averages
    (sad_calc_fasthalf, enc/enc_kernels.c:162 / scalar model
    enc/encode_block.c:497-603). Returns (best, x, y) with x/y in
    {-2, 0, 2} quarter-pel units."""
    o = org.astype(np.int32)

    def R(dy, dx):
        return refpad[by + dy:by + dy + height,
                      bx + dx:bx + dx + width].astype(np.int32)

    b00 = R(0, 0)
    t2 = _avg(R(-1, -1), R(-1, 0))
    t2b = _avg(R(0, -1), b00)
    t1 = (t2 + t2b) >> 1
    t3 = (_avg(R(-2, -1), R(1, -1)) + _avg(R(-2, 0), R(1, 0))) >> 1
    t5 = (_avg(R(-1, -2), R(-1, 1)) + _avg(R(0, -2), R(0, 1))) >> 1
    t5 = (t3 + t5) >> 1
    ptl = (t5 + t1) >> 1
    left = int(np.abs(o - t2b).sum())

    t1 = _avg(R(-1, 0), R(-1, 1))
    t8 = _avg(b00, R(0, 1))
    t1 = (t1 + t8) >> 1
    t4 = _avg(R(-2, 0), R(1, 0))
    t5r = _avg(R(-2, 1), R(1, 1))
    t3 = (t4 + t5r) >> 1
    t4b = _avg(R(-1, -1), R(-1, 2))
    t7 = _avg(R(0, -1), R(0, 2))
    t5 = (t7 + t4b) >> 1
    t5 = (t3 + t5) >> 1
    ptr = (t5 + t1) >> 1
    right = int(np.abs(o - t8).sum())

    t1b = _avg(R(1, -1), R(1, 0))
    t3 = (t1b + t2b) >> 1
    t2c = _avg(R(-1, -1), R(2, -1))
    t4c = _avg(R(-1, 0), R(2, 0))
    t5 = (t4c + t2c) >> 1
    t6 = _avg(R(0, -2), R(0, 1))
    t1c = _avg(R(1, -2), R(1, 1))
    t2d = (t6 + t1c) >> 1
    t2d = (t5 + t2d) >> 1
    pbl = (t2d + t3) >> 1

    t2e = _avg(R(1, 0), R(1, 1))
    t3 = (t8 + t2e) >> 1
    t5b = _avg(R(-1, 1), R(2, 1))
    t6b = (t4c + t5b) >> 1
    t8b = _avg(R(1, -1), R(1, 2))
    t1d = (t7 + t8b) >> 1
    t2f = (t6b + t1d) >> 1
    pbr = (t2f + t3) >> 1

    down = int(np.abs(o - _avg(b00, R(1, 0))).sum())
    top = int(np.abs(o - _avg(b00, R(-1, 0))).sum())
    tl = int(np.abs(o - ptl).sum())
    tr = int(np.abs(o - ptr).sum())
    br = int(np.abs(o - pbr).sum())
    bl = int(np.abs(o - pbl).sum())

    bestx, besty, best = 0, -2, top
    if down < best:
        besty, best = 2, down
    if right < best:
        bestx, besty, best = 2, 0, right
    if left < best:
        bestx, besty, best = -2, 0, left
    if tl < best:
        bestx, besty, best = -2, -2, tl
    if tr < best:
        bestx, besty, best = 2, -2, tr
    if br < best:
        bestx, besty, best = 2, 2, br
    if bl < best:
        bestx, besty, best = -2, 2, bl
    return best, bestx, besty


def sad_calc_fastquarter(org, refpad, by, bx, width, height, xin, yin):
    """8-position quarter-pel SAD around the half-pel position (xin, yin)
    (sad_calc_fastquarter, enc/encode_block.c:605-738). Returns
    (best, x, y) with x/y in {-1, 0, 1}."""
    o = org.astype(np.int32)

    def R(dy, dx):
        return refpad[by + dy:by + dy + height,
                      bx + dx:bx + dx + width].astype(np.int32)

    a = R(0, 0)
    d = R(0, 1)
    e = R(1, 1)
    f = R(1, 0)
    if (xin & yin) != 0:
        ad = _avg(a, d)
        de = _avg(d, e)
        af = _avg(a, f)
        fe = _avg(f, e)
        sums = {
            'tl': (ad + af) >> 1, 'top': (de + a) >> 1, 'tr': (ad + de) >> 1,
            'left': (ad + f) >> 1, 'right': (ad + e) >> 1,
            'bl': (af + fe) >> 1, 'down': (de + f) >> 1, 'br': (de + fe) >> 1}
    elif xin != 0:
        b = R(-1, 0)
        c = R(-1, 1)
        ad = _avg(a, d)
        de = _avg(d, e)
        dc = _avg(d, c)
        af = _avg(a, f)
        ab = _avg(a, b)
        sums = {
            'tl': (ad + ab) >> 1, 'top': (dc + a) >> 1, 'tr': (ad + dc) >> 1,
            'left': (ad + a) >> 1, 'right': (ad + d) >> 1,
            'bl': (ad + af) >> 1, 'down': (af + d) >> 1, 'br': (ad + de) >> 1}
    elif yin != 0:
        g = R(1, -1)
        h = R(0, -1)
        ad = _avg(a, d)
        af = _avg(a, f)
        fe = _avg(f, e)
        ah = _avg(a, h)
        gf = _avg(g, f)
        sums = {
            'tl': (ah + af) >> 1, 'top': (af + a) >> 1, 'tr': (ad + af) >> 1,
            'left': (gf + a) >> 1, 'right': (ad + f) >> 1,
            'bl': (af + gf) >> 1, 'down': (af + f) >> 1, 'br': (af + fe) >> 1}
    else:
        b = R(-1, 0)
        h = R(0, -1)
        ad = _avg(a, d)
        af = _avg(a, f)
        ah = _avg(a, h)
        ab = _avg(a, b)
        sums = {
            'tl': (ah + ab) >> 1, 'top': (ab + a) >> 1, 'tr': (ad + ab) >> 1,
            'left': (ah + a) >> 1, 'right': (ad + a) >> 1,
            'bl': (ah + af) >> 1, 'down': (af + a) >> 1, 'br': (af + ad) >> 1}

    s = {k: int(np.abs(o - v).sum()) for k, v in sums.items()}
    bestx, besty, best = 0, -1, s['top']
    if s['tl'] < best:
        bestx, best = -1, s['tl']
    if s['tr'] < best:
        bestx, best = 1, s['tr']
    if s['left'] < best:
        bestx, besty, best = -1, 0, s['left']
    if s['right'] < best:
        bestx, besty, best = 1, 0, s['right']
    if s['bl'] < best:
        bestx, besty, best = -1, 1, s['bl']
    if s['down'] < best:
        bestx, besty, best = 0, 1, s['down']
    if s['br'] < best:
        bestx, besty, best = 1, 1, s['br']
    return best, bestx, besty


def mv_mask_hash(x, y):
    return 1 << (((y << 3) ^ x) & 63)


class MVCandList:
    """Per-SB ME candidate store mirroring frame_info.mvcand: 64
    persistent slots with a count + 64-bit dedup hash mask
    (common/types.h mvcand fields, enc/encode_block.c:60-73). Slots keep
    their values across per-SB resets, which motion_estimate_bi/_sync
    observe when reading fixed indices beyond the count."""

    __slots__ = ("slots", "num", "mask")

    def __init__(self):
        self.slots = [(0, 0)] * 64
        self.num = 0
        self.mask = 0

    def reset(self):
        self.num = 0
        self.mask = 0

    def __len__(self):
        return self.num

    def __iter__(self):
        return iter(self.slots[:self.num])

    def __getitem__(self, i):
        return self.slots[i]

    def __setitem__(self, i, v):
        self.slots[i] = v


def add_mvcandidate(mv, cl: MVCandList):
    """Add a quarter-pel MV as an integer-pel candidate with hash dedup
    (add_mvcandidate, enc/encode_block.c:62-73)."""
    ix = (mv[0] + 2) >> 2
    iy = (mv[1] + 2) >> 2
    m = mv_mask_hash(ix, iy)
    if not (m & cl.mask):
        cl.slots[cl.num] = (ix, iy)
        cl.num += 1
    cl.mask |= m


def motion_estimate(org, refpad, size, width, height, mvc, mvp, lambda_me,
                    params, sign, fwidth, fheight, xpos, ypos, mvcand,
                    enable_bipred, oy_ref=None, ox_ref=None):
    """Integer + sub-pel MV search (enc/encode_block.c:830-1016).

    org: (height, width) block; refpad: padded ref luma plane. The MV
    clip uses the BLOCK origin (ypos, xpos) while the reference data
    window starts at (oy_ref, ox_ref) (equal for PART_NONE; offset for
    sub-PBs, mirroring the reference's pointer arithmetic).
    mvcand: list of integer-pel candidates. Returns (cost, (mvx, mvy)).
    """
    s = -1 if sign else 1
    if oy_ref is None:
        oy_ref, ox_ref = ypos, xpos
    base_y, base_x = PAD_Y + oy_ref, PAD_Y + ox_ref
    o32 = org.astype(np.int32)
    Hp, Wp = refpad.shape
    wins = np.lib.stride_tricks.sliding_window_view(refpad, (height, width))

    def origin(mvx, mvy):
        return base_y + s * (mvy >> 2), base_x + s * (mvx >> 2)

    def sads(pos):
        """The SADs of the windows at the (by, bx) of `pos`, in order: one
        gather where every window lies inside the plane, else window by
        window as sad_calc slices them."""
        ys, xs = [p[0] for p in pos], [p[1] for p in pos]
        if min(ys) >= 0 and min(xs) >= 0 and max(ys) <= Hp - height \
                and max(xs) <= Wp - width:
            return np.abs(o32 - wins[ys, xs]).sum(axis=(1, 2)).tolist()
        return [sad_calc(org, refpad[y:y + height, x:x + width])
                for y, x in pos]

    def mv_cost(mvx, mvy):
        return int(lambda_me * quote_mv_bits(mvy - mvp[1], mvx - mvp[0])
                   + 0.5)

    min_sad = (1 << 32) - 1
    mv_opt = (0, 0)
    mv_ref = (((mvc[0] + 2) >> 2) << 2, ((mvc[1] + 2) >> 2) << 2)

    # Every stage below evaluates a set of candidates fixed before it
    # starts: their SADs are taken together, then compared one by one in
    # the reference's order (the first strict minimum wins).
    if (size == 16 and enable_bipred) or params.encoder_speed == 0:
        step = 32
        while step >= 4:
            rng = 2 * step
            cands = [clip_mv(mv_ref[0] + l, mv_ref[1] + k, ypos, xpos,
                             fwidth, fheight, size, sign)
                     for k in range(-rng, rng + 1, step)
                     for l in range(-rng, rng + 1, step)
                     if step == 32 or k or l]
            if (step == 32 and size == 16
                    and 0 < params.encoder_speed < 2):
                costs = []
                for i, (cx, cy) in enumerate(cands):
                    sad, x = widesad_calc(org, refpad, *origin(cx, cy),
                                          width, height)
                    cands[i] = (cx + ((s * x) << 2), cy)
                    costs.append(sad)
            else:
                costs = sads([origin(cx, cy) for cx, cy in cands])
            for (cx, cy), sad in zip(cands, costs):
                sad += mv_cost(cx, cy)
                if sad < min_sad:
                    min_sad, mv_opt = sad, (cx, cy)
            mv_ref = mv_opt
            step >>= 1

    cands = [clip_mv(ix << 2, iy << 2, ypos, xpos, fwidth, fheight, size,
                     sign) for (ix, iy) in mvcand]
    if cands:
        pos = [origin(cx, cy) for cx, cy in cands]
        if size == 16:
            # widesad_calc's five positions x.xXx.x, the first minimum
            offs = (-3, -1, 0, 1, 3)
            flat = sads([(y, x + o) for y, x in pos for o in offs])
            costs = []
            for i, (cx, cy) in enumerate(cands):
                five = flat[5 * i:5 * i + 5]
                k = five.index(min(five))
                cands[i] = (cx + ((s * offs[k]) << 2), cy)
                costs.append(five[k])
        else:
            costs = sads(pos)
        for (cx, cy), sad in zip(cands, costs):
            sad += mv_cost(cx, cy)
            if sad < min_sad:
                min_sad, mv_opt = sad, (cx, cy)

    mv_ref = mv_opt
    maxsteps = 6 if (size <= 16 or params.encoder_speed == 0) else 0
    start, end = 0, 5
    DIY = [1, 2, 1, -1, -2, -1]
    DIX = [-1, 0, 1, 1, 0, -1]
    for step in range(1, maxsteps):
        dirs = [start % 6]
        while dirs[-1] != end:
            dirs.append((dirs[-1] + 1) % 6)
        # NB: the reference indexes diy into .y with dix into .x
        # swapped (enc/encode_block.c:908-911); mirror exactly.
        cands = [clip_mv(mv_ref[0] + DIY[d] * 4, mv_ref[1] + DIX[d] * 4,
                         ypos, xpos, fwidth, fheight, size, sign)
                 for d in dirs]
        best_dir = -1
        for d, (cx, cy), sad in zip(dirs, cands, sads(
                [origin(cx, cy) for cx, cy in cands])):
            sad += mv_cost(cx, cy)
            if sad < min_sad:
                min_sad, mv_opt, best_dir = sad, (cx, cy), d
        mv_ref = mv_opt
        start = best_dir - 1 if best_dir else 5
        end = start + 2
        if end >= 6:
            end -= 6
        if best_dir < 0:
            break

    cmin = min_sad
    xdelta_hp = ydelta_hp = xdelta_qp = ydelta_qp = 0

    if params.encoder_speed == 0:
        HM = [0, 0, -2, 2, 0, -2, -2, 2, 2]
        HN = [0, -2, 0, 0, 2, -2, 2, -2, 2]
        for i in range(1, 9):
            cy = mv_ref[1] + HM[i]
            cx = mv_ref[0] + HN[i]
            pred = K.mc_luma(refpad, base_y, base_x, height, width, cx, cy,
                             sign, enable_bipred)
            sad = sad_calc(org, pred) + mv_cost(cx, cy)
            if sad < cmin:
                cmin, ydelta_hp, xdelta_hp = sad, HM[i], HN[i]
        mv_opt = (mv_opt[0] + xdelta_hp, mv_opt[1] + ydelta_hp)
        QM = [0, 0, -1, 1, 0, -1, -1, 1, 1]
        QN = [0, -1, 0, 0, 1, -1, 1, -1, 1]
        for i in range(1, 9):
            cy = mv_opt[1] + QM[i]
            cx = mv_opt[0] + QN[i]
            pred = K.mc_luma(refpad, base_y, base_x, height, width, cx, cy,
                             sign, enable_bipred)
            sad = sad_calc(org, pred) + mv_cost(cx, cy)
            if sad < cmin:
                cmin, ydelta_qp, xdelta_qp = sad, QM[i], QN[i]
    else:
        # Faster bilinear approximation (enc/encode_block.c:977-1008).
        # NB two reference quirks mirrored exactly: mv_ref is multiplied
        # by s in place BEFORE the half-pel rate term (so the rate is
        # computed on the sign-folded vector), and the quarter-pel ref
        # address uses s*(x>>2) (shift before sign).
        rx, ry = mv_ref[0] * s, mv_ref[1] * s
        by = base_y + (ry >> 2)
        bx = base_x + (rx >> 2)
        sad, spx, spy = sad_calc_fasthalf(org, refpad, by, bx, width,
                                          height)
        sad += int(lambda_me * quote_mv_bits(
            ry + s * spy - mvp[1], rx + s * spx - mvp[0]) + 0.5)
        if sad < cmin:
            cmin = sad
            xdelta_hp, ydelta_hp = s * spx, s * spy
        spx, spy = xdelta_hp, ydelta_hp
        rx = mv_opt[0] + s * spx
        ry = mv_opt[1] + s * spy
        mv_opt = (mv_opt[0] + xdelta_hp, mv_opt[1] + ydelta_hp)
        by = base_y + s * (ry >> 2)
        bx = base_x + s * (rx >> 2)
        sad, qpx, qpy = sad_calc_fastquarter(org, refpad, by, bx, width,
                                             height, spx, spy)
        sad += int(lambda_me * quote_mv_bits(
            ry + s * qpy - mvp[1], rx + s * qpx - mvp[0]) + 0.5)
        if sad < cmin:
            cmin = sad
            xdelta_qp, ydelta_qp = s * qpx, s * qpy

    mv_opt = (mv_opt[0] + xdelta_qp, mv_opt[1] + ydelta_qp)
    return min(cmin, min_sad), mv_opt


def search_inter_prediction_params(org, refpad, binfo, mvc, mvp, part,
                                   lambda_me, params, sign, fwidth,
                                   fheight, mvcand, enable_bipred):
    """Per-PB-partition ME dispatch (enc/encode_block.c:1331-1397).
    Returns (sad, mv_arr[4]). mvcand is the shared MVCandList."""
    size = binfo.size
    ypos, xpos = binfo.ypos, binfo.xpos
    mvp2 = mvp
    mv_arr = [(0, 0)] * 4
    sad = 0
    if part == 0:
        me = motion_estimate_sync if params.sync else motion_estimate
        s, mv = me(org, refpad, size, size, size, mvc, mvp2,
                   lambda_me, params, sign, fwidth, fheight,
                   xpos, ypos, mvcand, enable_bipred)
        sad += s
        mv_arr = [mv] * 4
    elif part == 1:  # HOR
        h = size // 2
        for index in (0, 2):
            py = index >> 1
            sub = org[py * h:py * h + h, :]
            s, mv = motion_estimate(
                sub, refpad, size, size, h, mvc, mvp2, lambda_me,
                params, sign, fwidth, fheight, xpos, ypos, mvcand,
                enable_bipred, oy_ref=ypos + py * h, ox_ref=xpos)
            sad += s
            mv_arr[index] = mv_arr[index + 1] = mv
            mvp2 = mv_arr[0]
    elif part == 2:  # VER
        h = size // 2
        for index in (0, 1):
            px = index
            sub = org[:, px * h:px * h + h]
            s, mv = motion_estimate(
                sub, refpad, size, h, size, mvc, mvp2,
                lambda_me, params, sign, fwidth, fheight, xpos, ypos,
                mvcand, enable_bipred, oy_ref=ypos, ox_ref=xpos + px * h)
            sad += s
            mv_arr[index] = mv_arr[index + 2] = mv
            mvp2 = mv_arr[0]
    else:  # QUAD
        h = size // 2
        for index in range(4):
            px, py = index & 1, (index & 2) >> 1
            sub = org[py * h:py * h + h, px * h:px * h + h]
            s, mv = motion_estimate(
                sub, refpad, size, h, h, mvc, mvp2, lambda_me, params, sign,
                fwidth, fheight, xpos, ypos, mvcand, enable_bipred,
                oy_ref=ypos + py * h, ox_ref=xpos + px * h)
            sad += s
            mv_arr[index] = mv
            mvp2 = mv_arr[0]
    return sad, mv_arr


def motion_estimate_bi(org, refpad0, refpad1, size, width, height, mvc,
                       mvp, lambda_me, params, sign, fwidth, fheight,
                       xpos, ypos, mvcand, enable_bipred):
    """Symmetric bipred MV search with mv0 = -mv1
    (motion_estimate_bi, enc/encode_block.c:1102-1215).

    mvcand is the SHARED per-SB integer candidate list; the reference
    writes into fixed slots 0..5 of that array (padding to 4, mvp at [4],
    zero at [5]) without updating the count - those side effects on
    already-occupied slots are mirrored.
    Returns (sad, (mvx, mvy)).
    """

    def bipred_sad(cx, cy):
        c0x, c0y = clip_mv(cx, cy, ypos, xpos, fwidth, fheight, size, sign)
        p0 = K.mc_luma(refpad0, PAD_Y + ypos, PAD_Y + xpos, height, width,
                       c0x, c0y, sign, enable_bipred)
        c1x, c1y = clip_mv(c0x, c0y, ypos, xpos, fwidth, fheight, size,
                           1 - sign)
        p1 = K.mc_luma(refpad1, PAD_Y + ypos, PAD_Y + xpos, height, width,
                       c1x, c1y, 1 - sign, enable_bipred)
        rf = ((p0.astype(np.int32) + p1) >> 1).astype(np.uint8)
        s = sad_calc(org, rf)
        s += int(lambda_me * quote_mv_bits(c1y - mvp[1], c1x - mvp[0])
                 + 0.5)
        return s, (c1x, c1y)

    min_sad = (1 << 32) - 1
    mv_opt = (0, 0)
    mv_ref = (((mvc[0] + 2) >> 2) << 2, ((mvc[1] + 2) >> 2) << 2)
    step = 32
    while step > 0:
        rng = step
        for k in range(-rng, rng + 1, step):
            for l in range(-rng, rng + 1, step):
                if step < 32 and k == 0 and l == 0:
                    continue
                if step == 1:
                    vf, hf = mv_ref[1] & 3, mv_ref[0] & 3
                    if vf == 0 and hf == 0:
                        if abs(k) != abs(l):
                            continue
                    elif vf == 2 and hf == 2:
                        continue
                    else:
                        if abs(k) == abs(l):
                            continue
                s, mvq = bipred_sad(mv_ref[0] + l, mv_ref[1] + k)
                if s < min_sad:
                    min_sad, mv_opt = s, mvq
        mv_ref = mv_opt
        step >>= 1

    # Candidate slots 0..5 (the reference's "temporary workaround"):
    # pads slots num..3 with zeros, mvp at [4], zero at [5] - writing the
    # shared slot array in place (enc/encode_block.c:1177-1186).
    for i in range(len(mvcand), 4):
        mvcand[i] = (0, 0)
    mvcand[4] = (mvp[0], mvp[1])
    mvcand[5] = (0, 0)
    for i in range(6):
        cand = mvcand[i]
        s, mvq = bipred_sad(cand[0], cand[1])
        if s < min_sad:
            min_sad, mv_opt = s, mvq
    return min_sad, mv_opt


def motion_estimate_sync(org, refpad, size, width, height, mvc, mvp,
                         lambda_me, params, sign, fwidth, fheight, xpos,
                         ypos, mvcand, enable_bipred):
    """Deterministic telescope-to-quarter-pel search via real MC
    (motion_estimate_sync, enc/encode_block.c:1018-1100): block
    decisions independent of encoder-internal per-row candidate state
    (the basis for synchronized/parallel row encoding)."""

    def mc_sad(cx, cy):
        cx, cy = clip_mv(cx, cy, ypos, xpos, fwidth, fheight, size, sign)
        pred = K.mc_luma(refpad, PAD_Y + ypos, PAD_Y + xpos, height, width,
                         cx, cy, sign, enable_bipred)
        s = sad_calc(org, pred)
        s += int(lambda_me * quote_mv_bits(cy - mvp[1], cx - mvp[0]) + 0.5)
        return s, (cx, cy)

    min_sad = (1 << 32) - 1
    mv_opt = (0, 0)
    mv_ref = (((mvc[0] + 2) >> 2) << 2, ((mvc[1] + 2) >> 2) << 2)
    step = 32
    while step > 0:
        for k in range(-step, step + 1, step):
            for l in range(-step, step + 1, step):
                if step < 32 and k == 0 and l == 0:
                    continue
                if step == 1:
                    vf, hf = mv_ref[1] & 3, mv_ref[0] & 3
                    if vf == 0 and hf == 0:
                        if abs(k) != abs(l):
                            continue
                    elif vf == 2 and hf == 2:
                        continue
                    else:
                        if abs(k) == abs(l):
                            continue
                s, mvq = mc_sad(mv_ref[0] + l, mv_ref[1] + k)
                if s < min_sad:
                    min_sad, mv_opt = s, mvq
        mv_ref = mv_opt
        step >>= 1

    mvcand[4] = (mvp[0], mvp[1])
    mvcand[5] = (0, 0)
    for i in range(6):
        cand = mvcand[i]
        s, mvq = mc_sad(cand[0], cand[1])
        if s < min_sad:
            min_sad, mv_opt = s, mvq
    return min_sad, mv_opt
