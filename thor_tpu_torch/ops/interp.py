"""Temporal frame interpolation: the synthesized reference of interp_ref
streams (common/temporal_interp.c:972-1053; decoder and encoder build it
identically, so every value is exact integer data).

Counterpart of thor_tpu/ops/device_interp.py (the pyramid and its XLA
forms) and thor_tpu/ops/pallas_interp.py (the three TPU kernels):

- pyramid build (2x2 box downscale) and the 2x MV upscale between levels:
  plain tensor ops on every device, as they are XLA ops in thor_tpu;
- `me_level`: one pyramid level of bidirectional block ME plus the merge
  smoothing pass (TPU kernel _me_level_kernel, which decides the blocks in
  raster order);
- `mot_comp`, `mot_comp_uv`: the averaged bi-MC synthesis of the luma plane
  and of the U/V pair (TPU kernels _mot_comp_kernel, _mot_comp_kernel_uv),
  written with the codec padding of a reference plane; the U/V pass
  derives its vectors from the luma field.

Each of the three has a CUDA kernel (csrc/interp_me.cu, csrc/interp_mc.cu)
and a plain PyTorch version here. A wrapper takes the plain version for a
CPU tensor; for a CUDA tensor it launches the kernel or raises.

Neither the plain ME nor the kernel walks the 16x16 blocks one by one:
block (r, c) reads the decided vectors of (r-1, c+1), (r, c-1), (r-1, c)
and (r-1, c-1), so all blocks with the same c + 2r are independent. The
plain version decides them together, wavefront by wavefront; the kernel
gives every block row a thread block that runs two blocks behind the row
above. Both keep the arithmetic of the raster walk.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .kernels import edge_pad

BLOCK_STEP = 16
COST_MAX = 0x3FFFFFFF
LAMBDA = (3000 * BLOCK_STEP) // 16
LAMBDA_SHIFT = 4
SKIP_THRESHOLD = 8
ACC_BITS = 3
ACC_ROUND = 1 << (ACC_BITS - 1)
MAX_LEVELS = 4
PAD_Y = 96          # codec padding of the luma reference planes
PAD_C = 48
PAD_L = 32          # padding of the upper pyramid levels

I32 = torch.int32
U8 = torch.uint8


# ---------------------------------------------------------------------------
# Plain tensor ops of the pyramid (every device)
# ---------------------------------------------------------------------------

def _scale_val(v, numer: int, denom: int):
    """Exact _scale_val: round half away from zero. denom (= wt0) is
    positive, so both floor divisions act on non-negative integers."""
    prod = v * numer
    mag = (prod.abs() + denom // 2) // denom
    return torch.where(prod >= 0, mag, -mag)


def _rs(v):
    """MV in 1/8 pel -> whole-pel offset (arithmetic shift)."""
    return (v + ACC_ROUND) >> ACC_BITS


def me_grid(w: int, h: int):
    """(bw, bh): the 8x8-cell grid of a w x h level (whole 16x16 blocks)."""
    return (2 * ((w + BLOCK_STEP - 1) // BLOCK_STEP),
            2 * ((h + BLOCK_STEP - 1) // BLOCK_STEP))


def num_levels(w: int, h: int) -> int:
    return min(MAX_LEVELS,
               int(math.log10(min(w, h)) / math.log10(2.0) - 4.0))


def downscale2x2(yp, pad_in: int, w: int, h: int, pad_out: int):
    """Padded level plane -> the next level's padded plane; an odd last
    row or column is dropped."""
    src = yp[pad_in:pad_in + 2 * (h // 2),
             pad_in:pad_in + 2 * (w // 2)].to(I32)
    col = (src[0::2] + src[1::2] + 1) >> 1
    out = ((col[:, 0::2] + col[:, 1::2]) >> 1).to(U8)
    return edge_pad(out, pad_out)


def upscale_mv(m, bwo: int, bho: int):
    """[bhi, bwi] MV component map -> [bho, bwo] on the 2x finer grid
    (upscale_mv_data, temporal_interp.c:247-271)."""
    bhi, bwi = m.shape
    yi = (torch.arange(bho, device=m.device) // 2).clamp(max=bhi - 1)
    xi = (torch.arange(bwo, device=m.device) // 2).clamp(max=bwi - 1)
    return m[yi][:, xi] * 2


def _windows(flat, stride: int, ys, xs, size: int, lo: int, hi_y: int,
             hi_x: int, base: int):
    """[..., size, size] int32 windows whose top-left corners are the
    frame coordinates (ys, xs), every pixel coordinate clipped to
    [lo, hi] on its own (sad_cost's / mot_comp_avg's clipped branch).
    `flat` is the flattened padded plane whose frame pixel (0, 0) sits at
    (base, base)."""
    d = torch.arange(size, device=flat.device, dtype=I32)
    y = (ys[..., None] + d).clamp(lo, hi_y) + base
    x = (xs[..., None] + d).clamp(lo, hi_x) + base
    idx = (y * stride)[..., :, None] + x[..., None, :]
    return flat[idx.long()].to(I32)


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the three kernels
# ---------------------------------------------------------------------------

def me_level_plain(pic0p, pic1p, guide_x, guide_y, wts, *, w: int, h: int,
                   pad: int, guided: bool):
    """One pyramid level's bidirectional ME and merge pass, in tensor ops
    (thor_tpu device_interp._me_level_fn). Arguments and result as
    `me_level`."""
    me_level_plain.calls += 1
    dev = pic0p.device
    wt0, wt1 = int(wts[0]), int(wts[1])
    bs, bbs = BLOCK_STEP // 2, BLOCK_STEP
    bw, bh = me_grid(w, h)
    BW, BH = bw // 2, bh // 2
    hP, wP = h + pad, w + pad
    lam = LAMBDA // 4 if guided else LAMBDA
    n_ref_iters = 2 if guided else 16
    shift0 = ACC_BITS if guided else 3 + ACC_BITS
    thr = SKIP_THRESHOLD * 8 * 8
    stride = pic0p.shape[1]
    f0, f1 = pic0p.reshape(-1), pic1p.reshape(-1)

    def scale(v):
        return _scale_val(v, -wt1, wt0)

    def absdiff(x0, y0, mx, my, size):
        """|window of pic0 at the scaled MV - window of pic1 at the MV|."""
        a = _windows(f0, stride, y0 + _rs(scale(my)), x0 + _rs(scale(mx)),
                     size, -pad, hP - 1, wP - 1, pad)
        b = _windows(f1, stride, y0 + _rs(my), x0 + _rs(mx),
                     size, -pad, hP - 1, wP - 1, pad)
        return (a - b).abs()

    def inside(s, lim):
        """Both 8-wide halves of a 16-wide span starting at s lie in
        [-pad, lim]: [n, 2]."""
        o = s[:, None] + torch.tensor([0, bs], device=dev, dtype=I32)
        return (o >= -pad) & (o + bs <= lim)

    # block-level maps: every 16x16 block fills its 2x2 cells alike
    B1x = torch.zeros((BH, BW), dtype=I32, device=dev)
    B1y = torch.zeros_like(B1x)
    B0x = torch.zeros_like(B1x)
    B0y = torch.zeros_like(B1x)
    BG = torch.zeros_like(B1x)
    dxs4 = torch.tensor([-1, 1, 0, 0], device=dev, dtype=I32)
    dys4 = torch.tensor([0, 0, -1, 1], device=dev, dtype=I32)
    K = 5 if guided else 4

    for t in range(BW + 2 * (BH - 1)):
        r = torch.arange(max(0, (t - BW + 2) // 2), min(BH - 1, t // 2) + 1,
                         device=dev)
        c = t - 2 * r
        n = len(r)
        xstart = (c * bbs).to(I32)
        ystart = (r * bbs).to(I32)
        up_ok = r > 0
        upr_ok = up_ok & (c < BW - 1)
        left_ok = c > 0

        def nb(dr, dc):
            """Decided mv1 of a neighbour block; the index is clamped
            and the caller masks by validity."""
            rr = (r + dr).clamp(0, BH - 1)
            cc = (c + dc).clamp(0, BW - 1)
            return B1x[rr, cc], B1y[rr, cc]

        nux, nuy = nb(-1, 0)
        nrx, nry = nb(-1, 1)
        nlx, nly = nb(0, -1)
        ndx, ndy = nb(-1, -1)

        # skip vector: |.|-distance medoid of the valid neighbours in
        # the order up-right, left, up; ties keep the last <=
        cxs, cys = (nrx, nlx, nux), (nry, nly, nuy)
        cvs = (upr_ok, left_ok, up_ok)
        best_c = torch.full((n,), COST_MAX, dtype=I32, device=dev)
        skx = torch.zeros((n,), dtype=I32, device=dev)
        sky = torch.zeros_like(skx)
        for j in range(3):
            d = torch.zeros_like(skx)
            for i in range(3):
                d = d + torch.where(
                    cvs[i], (cxs[j] - cxs[i]).abs() + (cys[j] - cys[i]).abs(),
                    0)
            take = cvs[j] & (d <= best_c)
            best_c = torch.where(take, d, best_c)
            skx = torch.where(take, cxs[j], skx)
            sky = torch.where(take, cys[j], sky)
        ssx, ssy = scale(skx), scale(sky)

        # skip test: the four 8x8 sub-SADs of one 16x16 window pair all
        # under the threshold, and all eight windows inside the planes
        ad = absdiff(xstart, ystart, skx, sky, bbs)
        s8 = ad.reshape(n, 2, bs, 2, bs).sum((2, 4))          # [n, dy, dx]
        in_y = inside(ystart + _rs(ssy), hP) & inside(ystart + _rs(sky), hP)
        in_x = inside(xstart + _rs(ssx), wP) & inside(xstart + _rs(skx), wP)
        sk = (in_y[:, :, None] & in_x[:, None, :]
              & (s8 <= thr)).reshape(n, 4).all(1)

        # candidates: zero, guide (guided levels), up-right, left, up;
        # a slot equal to an earlier valid slot is dropped
        zero = torch.zeros_like(skx)
        true = torch.ones((n,), dtype=torch.bool, device=dev)
        cand = [(zero, zero, true)]
        if guided:
            cand.append((guide_x[2 * r, 2 * c], guide_y[2 * r, 2 * c], true))
        cand += [(nrx, nry, upr_ok), (nlx, nly, left_ok), (nux, nuy, up_ok)]
        cv = []
        for j in range(K):
            dup = torch.zeros_like(true)
            for i in range(j):
                dup = dup | ((cand[j][0] == cand[i][0])
                             & (cand[j][1] == cand[i][1]) & cv[i])
            cv.append(cand[j][2] & ~dup)
        cx = torch.stack([q[0] for q in cand], 1)             # [n, K]
        cy = torch.stack([q[1] for q in cand], 1)

        in4 = (up_ok & left_ok & (c < BW - 1))[:, None]
        row0 = ((r == 0) & left_ok)[:, None]
        col0 = ((c == 0) & up_ok)[:, None]

        def full_cost(mx, my):
            """Rate term + bi-SAD of [n, M] vectors."""
            def dist(ax, ay):
                return (mx - ax[:, None]).abs() + (my - ay[:, None]).abs()
            d_r, d_u, d_l = dist(nrx, nry), dist(nux, nuy), dist(nlx, nly)
            diff = torch.where(
                in4, d_r + d_u + dist(ndx, ndy) + d_l,
                torch.where(row0, d_l, torch.where(col0, d_r + d_u, 0)))
            rate = (diff * lam) >> (LAMBDA_SHIFT + ACC_BITS)
            sad = absdiff(xstart[:, None], ystart[:, None], mx, my,
                          bbs).sum((2, 3))
            return rate + sad.to(I32)

        # the refinement of a candidate does not depend on the other
        # candidates, only whether it is run does (the pruning gate), so
        # all K refine together and the gate picks afterwards
        cost0 = full_cost(cx, cy)
        cost, rx, ry = cost0, cx, cy
        shift = torch.full((n, K), shift0, dtype=I32, device=dev)
        active = torch.ones((n, K), dtype=torch.bool, device=dev)
        for _ in range(n_ref_iters):
            off = (1 << shift.clamp(min=0))[:, :, None]
            pxs = rx[:, :, None] + dxs4 * off        # the four cross points
            pys = ry[:, :, None] + dys4 * off        # of the step's start
            bc = full_cost(pxs.reshape(n, K * 4),
                           pys.reshape(n, K * 4)).reshape(n, K, 4)
            it_better = torch.zeros_like(active)
            for d in range(4):
                better = active & (bc[:, :, d] < cost)
                cost = torch.where(better, bc[:, :, d], cost)
                rx = torch.where(better, pxs[:, :, d], rx)
                ry = torch.where(better, pys[:, :, d], ry)
                it_better = it_better | better
            shift = torch.where(it_better, shift, shift - 1)
            active = active & (shift >= ACC_BITS)

        best_cost = torch.full((n,), COST_MAX, dtype=I32, device=dev)
        best_x, best_y = cx[:, 0], cy[:, 0]
        c_eff = torch.zeros((n,), dtype=I32, device=dev)
        for k in range(K):
            gate = cv[k] & (((4 + c_eff) * cost0[:, k]) // 8 < best_cost)
            c_eff = c_eff + cv[k].to(I32)
            ck = torch.where(gate, cost[:, k], cost0[:, k])
            upd = cv[k] & (ck < best_cost)
            best_cost = torch.where(upd, ck, best_cost)
            best_x = torch.where(upd, torch.where(gate, rx[:, k], cx[:, k]),
                                 best_x)
            best_y = torch.where(upd, torch.where(gate, ry[:, k], cy[:, k]),
                                 best_y)

        # on a skip block mv1 is the skip vector and mv0 its scaled twin
        B1x[r, c] = torch.where(sk, skx, best_x)
        B1y[r, c] = torch.where(sk, sky, best_y)
        B0x[r, c] = torch.where(sk, ssx, scale(best_x))
        B0y[r, c] = torch.where(sk, ssy, scale(best_y))
        BG[r, c] = sk.to(I32)

    def cells(b):
        return b.repeat_interleave(2, 0).repeat_interleave(2, 1)

    m1x, m1y, m0x, m0y, bg = (cells(b) for b in (B1x, B1y, B0x, B0y, BG))

    # merge smoothing pass: reads only the pre-merge map, all cells at once
    ii = torch.arange(bh, device=dev)[:, None]
    jj = torch.arange(bw, device=dev)[None, :]
    off = torch.where((ii & 1) != 0, 2, 1)        # keyed on the row, both axes

    def cell_at(dy, dx):
        yi, xi = ii + dy, jj + dx
        ok = (yi >= 0) & (yi < bh) & (xi >= 0) & (xi < bw)
        yc, xc = yi.clamp(0, bh - 1), xi.clamp(0, bw - 1)
        return m1x[yc, xc], m1y[yc, xc], ok.expand(bh, bw)

    zo = torch.zeros_like(off)
    mc = [(m1x, m1y, torch.ones((bh, bw), dtype=torch.bool, device=dev)),
          cell_at(-off, zo), cell_at(off, zo), cell_at(zo, -off),
          cell_at(zo, off)]
    oks = []
    for j in range(5):
        dup = torch.zeros((bh, bw), dtype=torch.bool, device=dev)
        for i in range(j):
            dup = dup | ((mc[j][0] == mc[i][0]) & (mc[j][1] == mc[i][1])
                         & oks[i])
        oks.append(mc[j][2] & ~dup)
    multi = sum(o.to(I32) for o in oks) > 1
    xs_cell = (jj * bs).to(I32).expand(bh, bw)
    ys_cell = (ii * bs).to(I32).expand(bh, bw)
    bcost = torch.full((bh, bw), COST_MAX, dtype=I32, device=dev)
    bx = torch.zeros((bh, bw), dtype=I32, device=dev)
    by = torch.zeros_like(bx)
    for k in range(5):
        s = absdiff(xs_cell, ys_cell, mc[k][0], mc[k][1], bs).sum((2, 3)) \
            .to(I32)
        take = oks[k] & (s < bcost)
        bcost = torch.where(take, s, bcost)
        bx = torch.where(take, mc[k][0], bx)
        by = torch.where(take, mc[k][1], by)
    return (torch.where(multi, scale(bx), m0x),
            torch.where(multi, scale(by), m0y),
            torch.where(multi, bx, m1x), torch.where(multi, by, m1y), bg)


me_level_plain.calls = 0


def _comp_plane(p0p, p1p, mv0, mv1, w, h, cs, clip_pad, base):
    """mot_comp_avg over one plane (device_interp._mot_comp_fn.comp_plane):
    per cs x cs cell the two windows clipped to the +-clip_pad halo, their
    rounded average, or the one window that lies inside when only one
    does."""
    bh, bw = mv0.shape[:2]
    dev = p0p.device
    hP, wP = h + clip_pad, w + clip_pad
    xs_c = (torch.arange(bw, device=dev, dtype=I32) * cs)[None, :]
    ys_c = (torch.arange(bh, device=dev, dtype=I32) * cs)[:, None]
    xs0, ys0 = xs_c + _rs(mv0[:, :, 0]), ys_c + _rs(mv0[:, :, 1])
    xs1, ys1 = xs_c + _rs(mv1[:, :, 0]), ys_c + _rs(mv1[:, :, 1])

    def inside(xs, ys):
        return ((xs >= -clip_pad) & (xs + cs <= wP) & (ys >= -clip_pad)
                & (ys + cs <= hP))[:, :, None, None]

    in0, in1 = inside(xs0, ys0), inside(xs1, ys1)
    stride = p0p.shape[1]
    a = _windows(p0p.reshape(-1), stride, ys0, xs0, cs, -clip_pad, hP - 1,
                 wP - 1, base)
    b = _windows(p1p.reshape(-1), stride, ys1, xs1, cs, -clip_pad, hP - 1,
                 wP - 1, base)
    avg = (a + b + 1) >> 1
    px = torch.where(in0 & in1, avg,
                     torch.where(in1 & ~in0, b,
                                 torch.where(in0 & ~in1, a, avg)))
    out = px.permute(0, 2, 1, 3).reshape(bh * cs, bw * cs)
    return out[:h, :w].to(U8).contiguous()


# (cs, clip_pad) of each synthesis kernel (compile-time constants of
# csrc/interp_mc.cu): the luma and the chroma cells of the frame
MC_GEOMETRY = {"mot_comp": (BLOCK_STEP // 2, BLOCK_STEP // 4),
               "mot_comp_uv": (BLOCK_STEP // 4, BLOCK_STEP // 8)}
MC_MARGIN = 8       # least base - clip_pad: room for the aligned loads


def mot_comp_plain(p0p, p1p, mv0, mv1, *, w: int, h: int, base: int,
                   pad: int = 0):
    """Plain version of `mot_comp`."""
    mot_comp_plain.calls += 1
    cs, clip_pad = MC_GEOMETRY["mot_comp"]
    return edge_pad(_comp_plane(p0p, p1p, mv0, mv1, w, h, cs, clip_pad, base),
                    pad)


mot_comp_plain.calls = 0


def chroma_vectors(m1, wts):
    """(c0, c1): the U/V cell vectors of the interpolated frame from the
    luma mv1 field, c1 = m1 >> 1 and c0 its twin scaled by -wt1 / wt0
    (thor_tpu pallas_interp.interpolate_frames_pallas)."""
    c1 = m1 >> 1
    return _scale_val(c1, -int(wts[1]), int(wts[0])), c1


def mot_comp_uv_plain(p0u, p1u, p0v, p1v, m1, wts, *, w: int, h: int,
                      base: int, pad: int = 0):
    """Plain version of `mot_comp_uv`."""
    mot_comp_uv_plain.calls += 1
    cs, clip_pad = MC_GEOMETRY["mot_comp_uv"]
    c0, c1 = chroma_vectors(m1, wts)
    return tuple(edge_pad(_comp_plane(p0, p1, c0, c1, w, h, cs, clip_pad,
                                      base), pad)
                 for p0, p1 in ((p0u, p1u), (p0v, p1v)))


mot_comp_uv_plain.calls = 0


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_libs: dict = {}


def _kernel(name: str):
    if name not in _libs:
        L = _build.cuda_library(name)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        if name == "interp_me":
            L.thor_interp_me_level.restype = ci
            L.thor_interp_me_level.argtypes = [vp, vp] + [ci] * 6 + [vp] * 6
        else:
            L.thor_interp_mot_comp.restype = ci
            L.thor_interp_mot_comp.argtypes = [vp] * 5 + [ci] * 6 + [vp]
            L.thor_interp_mot_comp_uv.restype = ci
            L.thor_interp_mot_comp_uv.argtypes = [vp] * 7 + [ci] * 8 + [vp]
        L.thor_cuda_error_string.restype = ctypes.c_char_p
        L.thor_cuda_error_string.argtypes = [ci]
        _libs[name] = L
    return _libs[name]


def _check(fn: str, dev, tensors):
    """Every (name, tensor, dtype, shape) is contiguous, on `dev`, of
    that type and shape; the kernels take nothing else."""
    if dev.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {dev}")
    for name, t, dt, shape in tensors:
        if (t.device != dev or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"{fn}: {name} must be a contiguous {dt} tensor of shape "
                f"{shape} on {dev}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")


def _raise_on(err: int, fn: str, L):
    if err:
        raise RuntimeError(f"{fn} launch failed: "
                           + L.thor_cuda_error_string(err).decode())


def me_level(pic0p, pic1p, guide_x, guide_y, wts, *, w: int, h: int,
             pad: int, guided: bool, stats=None):
    """One pyramid level of bidirectional ME plus the merge pass.

    pic0p, pic1p: [h + 2 pad, w + 2 pad] uint8 padded planes (swapped by
    the caller on the reversed path); guide_x, guide_y: [bh, bw] int32,
    read on guided levels only; wts: (wt0, wt1) integers. Returns the
    post-merge maps (mv0x, mv0y, mv1x, mv1y, bg), each [bh, bw] int32.
    A CPU tensor takes the plain version; a CUDA tensor launches
    csrc/interp_me.cu. `stats`, on the card only: an int64 [2] tensor to
    which the kernel adds the 16x16 SAD evaluations the walk needed (the
    skip test, the base costs and the gated refinements, not what it
    evaluated ahead of the gate) and the 8x8 ones of the merge pass.
    """
    if pic0p.device.type == "cpu":
        return me_level_plain(pic0p, pic1p, guide_x, guide_y, wts, w=w, h=h,
                              pad=pad, guided=guided)
    dev = pic0p.device
    bw, bh = me_grid(w, h)
    shape = (h + 2 * pad, w + 2 * pad)
    _check("me_level", dev, [("pic0p", pic0p, U8, shape),
                             ("pic1p", pic1p, U8, shape)]
           + ([("guide_x", guide_x, I32, (bh, bw)),
               ("guide_y", guide_y, I32, (bh, bw))] if guided else [])
           + ([("stats", stats, torch.int64, (2,))] if stats is not None
              else []))
    wt0, wt1 = int(wts[0]), int(wts[1])
    if wt0 <= 0:
        raise ValueError("me_level: wt0 must be positive")
    # the five pre-merge maps (undecided: 0), then the row ticket and one
    # progress counter per row of 16x16 blocks; zeroed on the stream
    pre = torch.zeros(5 * bh * bw + bh // 2 + 1, dtype=I32, device=dev)
    out = torch.empty((5, bh, bw), dtype=I32, device=dev)
    L = _kernel("interp_me")
    _raise_on(L.thor_interp_me_level(
        pic0p.data_ptr(), pic1p.data_ptr(), w, h, pad, wt0, wt1,
        int(guided), guide_x.data_ptr() if guided else None,
        guide_y.data_ptr() if guided else None, pre.data_ptr(),
        out.data_ptr(), stats.data_ptr() if stats is not None else None,
        torch.cuda.current_stream(dev).cuda_stream), "me_level", L)
    me_level.launches += 1
    return tuple(out[i] for i in range(5))


me_level.launches = 0


def _mc_args(fn, mv, w, h, base, pad):
    """Refuse what the synthesis kernels do not take, on every device."""
    cs, clip_pad = MC_GEOMETRY[fn]
    bh, bw = mv.shape[:2]
    if bh * cs < h or bw * cs < w:
        raise ValueError(f"{fn}: a {bw}x{bh} grid of {cs}x{cs} cells does "
                         f"not cover {w}x{h}")
    if base < clip_pad + MC_MARGIN:
        raise ValueError(f"{fn}: base {base} < clip_pad + {MC_MARGIN}")
    if pad < 0 or pad % cs:
        raise ValueError(f"{fn}: pad {pad} is not a non-negative multiple "
                         f"of cs {cs}")


def _check_mc(fn, dev, planes, vecs, w, h, base):
    """The [h + 2 base, w + 2 base] uint8 planes and the [bh, bw, 2] int32
    vector fields (named) of one synthesis call."""
    shape, vshape = (h + 2 * base, w + 2 * base), tuple(vecs[0][1].shape)
    _check(fn, dev, [(f"plane {i}", p, U8, shape)
                     for i, p in enumerate(planes)]
           + [(name, v, I32, vshape[:2] + (2,)) for name, v in vecs])


def mot_comp(p0p, p1p, mv0, mv1, *, w: int, h: int, base: int, pad: int = 0):
    """Averaged bi-MC synthesis of the luma plane.

    p0p, p1p: [h + 2 base, w + 2 base] uint8 codec-padded planes; mv0,
    mv1: [bh, bw, 2] int32 cell vectors (x, y), one per cs x cs cell;
    windows are clipped to +-clip_pad around the plane ((cs, clip_pad) is
    MC_GEOMETRY's; base >= clip_pad + MC_MARGIN). Returns the [h, w] uint8
    plane edge-padded by `pad` (a multiple of cs): [h + 2 pad, w + 2 pad].
    CPU tensor: plain version; CUDA tensor: csrc/interp_mc.cu, one
    launch."""
    _mc_args("mot_comp", mv0, w, h, base, pad)
    if p0p.device.type == "cpu":
        return mot_comp_plain(p0p, p1p, mv0, mv1, w=w, h=h, base=base,
                              pad=pad)
    dev = p0p.device
    bh, bw = mv0.shape[:2]
    _check_mc("mot_comp", dev, (p0p, p1p), [("mv0", mv0), ("mv1", mv1)], w,
              h, base)
    out = torch.empty((h + 2 * pad, w + 2 * pad), dtype=U8, device=dev)
    L = _kernel("interp_mc")
    _raise_on(L.thor_interp_mot_comp(
        p0p.data_ptr(), p1p.data_ptr(), out.data_ptr(), mv0.data_ptr(),
        mv1.data_ptr(), bw, bh, w, h, base, pad,
        torch.cuda.current_stream(dev).cuda_stream), "mot_comp", L)
    mot_comp.launches += 1
    return out


mot_comp.launches = 0


def mot_comp_uv(p0u, p1u, p0v, p1v, m1, wts, *, w: int, h: int, base: int,
                pad: int = 0):
    """`mot_comp` for U and V in one pass on the vectors
    `chroma_vectors(m1, wts)`, which the kernel derives per cell from the
    luma mv1 field m1 ([bh, bw, 2] int32 on the chroma cell grid) and the
    weights (wt0 > 0, wt1). Returns (u, v), each [h + 2 pad, w + 2 pad]
    uint8."""
    _mc_args("mot_comp_uv", m1, w, h, base, pad)
    wt0, wt1 = int(wts[0]), int(wts[1])
    if wt0 <= 0:
        raise ValueError("mot_comp_uv: wt0 must be positive")
    if p0u.device.type == "cpu":
        return mot_comp_uv_plain(p0u, p1u, p0v, p1v, m1, (wt0, wt1), w=w, h=h,
                                 base=base, pad=pad)
    dev = p0u.device
    bh, bw = m1.shape[:2]
    _check_mc("mot_comp_uv", dev, (p0u, p1u, p0v, p1v), [("m1", m1)], w, h,
              base)
    u, v = (torch.empty((h + 2 * pad, w + 2 * pad), dtype=U8, device=dev)
            for _ in range(2))
    L = _kernel("interp_mc")
    _raise_on(L.thor_interp_mot_comp_uv(
        p0u.data_ptr(), p1u.data_ptr(), p0v.data_ptr(), p1v.data_ptr(),
        u.data_ptr(), v.data_ptr(), m1.data_ptr(), bw, bh, w, h, base, pad,
        wt0, wt1, torch.cuda.current_stream(dev).cuda_stream),
        "mot_comp_uv", L)
    mot_comp_uv.launches += 1
    return u, v


mot_comp_uv.launches = 0


# ---------------------------------------------------------------------------
# The pyramid
# ---------------------------------------------------------------------------

def build_pyramid(yp, w: int, h: int, levels: int):
    """[(padded plane, pad)] per level, finest first."""
    lv = [(yp, PAD_Y)]
    for l in range(levels - 1):
        lv.append((downscale2x2(lv[-1][0], lv[-1][1], w >> l, h >> l, PAD_L),
                   PAD_L))
    return lv


def interp_weights(ratio: int, pos: int):
    """(reversed, wt0, wt1) of a frame at `pos` of `ratio` between its
    two references."""
    rev = pos > ratio // 2
    wt0 = pos if rev else ratio - pos
    return rev, wt0, ratio - wt0


def estimate_motion(lv0, lv1, w: int, h: int, wts, on_level=None):
    """Coarse-to-fine ME over two pyramids (already swapped on the
    reversed path). Returns level 0's maps (mv0x, mv0y, mv1x, mv1y, bg),
    each [bh, bw] int32. `on_level(lvl, args, kwargs, maps)` sees every
    me_level call."""
    gx = gy = None
    maps = None
    for lvl in range(len(lv0) - 1, -1, -1):
        wl, hl = w >> lvl, h >> lvl
        args = (lv0[lvl][0], lv1[lvl][0], gx, gy, wts)
        kw = dict(w=wl, h=hl, pad=lv0[lvl][1], guided=gx is not None)
        maps = me_level(*args, **kw)
        if on_level is not None:
            on_level(lvl, args, kw, maps)
        if lvl > 0:
            bwo, bho = me_grid(w >> (lvl - 1), h >> (lvl - 1))
            gx = upscale_mv(maps[2], bwo, bho)
            gy = upscale_mv(maps[3], bwo, bho)
    return maps


def cell_vectors(maps):
    """(mv0, mv1), each [bh, bw, 2] int32 (x, y), from a level's maps."""
    return (torch.stack([maps[0], maps[1]], -1),
            torch.stack([maps[2], maps[3]], -1))


def level0_motion(ref0, ref1, ratio: int, pos: int, on_level=None):
    """The motion search of the frame at `pos` of `ratio` between two
    references: (ref0, ref1 as the reversed path swaps them, level 0's
    maps, (wt0, wt1), w, h), the arguments of `synthesize`. `on_level` as
    in `estimate_motion`."""
    h, w = ref0.y.shape[0] - 2 * PAD_Y, ref0.y.shape[1] - 2 * PAD_Y
    rev, wt0, wt1 = interp_weights(ratio, pos)
    if rev:
        ref0, ref1 = ref1, ref0
    levels = num_levels(w, h)
    maps = estimate_motion(build_pyramid(ref0.y, w, h, levels),
                           build_pyramid(ref1.y, w, h, levels), w, h,
                           (wt0, wt1), on_level=on_level)
    return ref0, ref1, maps, (wt0, wt1), w, h


def synthesize(ref0, ref1, maps, wts, w: int, h: int):
    """Level 0's maps -> (y, u, v, yp, up, vp): the interpolated frame's
    three planes with their codec padding (96 / 48), written by the two
    synthesis kernels, and views of their interiors. U and V use the
    vectors the kernel derives from the luma mv1 and the weights. On the
    card: four launches (the two stacks of `cell_vectors`, `mot_comp`,
    `mot_comp_uv`)."""
    m0, m1 = cell_vectors(maps)
    yp = mot_comp(ref0.y, ref1.y, m0, m1, w=w, h=h, base=PAD_Y, pad=PAD_Y)
    up, vp = mot_comp_uv(ref0.u, ref1.u, ref0.v, ref1.v, m1, wts, w=w // 2,
                         h=h // 2, base=PAD_C, pad=PAD_C)
    return (yp[PAD_Y:PAD_Y + h, PAD_Y:PAD_Y + w],
            *(p[PAD_C:PAD_C + h // 2, PAD_C:PAD_C + w // 2] for p in (up, vp)),
            yp, up, vp)


def interpolate_frames(ref0, ref1, ratio: int, pos: int):
    """Synthesize the frame at `pos` of `ratio` between two references.

    ref0, ref1: objects whose .y / .u / .v are codec-padded uint8 planes
    (pads 96 / 48) on one device. Returns (y, u, v, yp, up, vp): the
    edge-padded reference planes and views of their unpadded interiors, on
    that device. Nothing here waits for the device or reads a value from
    it (thor_tpu pallas_interp.interpolate_frames_pallas)."""
    return synthesize(*level0_motion(ref0, ref1, ratio, pos))
