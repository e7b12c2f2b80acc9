"""Whole-frame motion estimation of the device encoder's P and B frames.

Counterpart of thor_tpu/enc/device_me.py (me_frame_body). Every block of
every size (8, 16, 32, 64) goes through one coarse-to-fine schedule at
once, per reference:

 1. L2 (quarter resolution): exhaustive +-8 search, the SADs of all 289
    displacements taken as global-shift maps and box-summed to the
    16 / 32 / 64 block grids; 8-blocks start from their 16-parent.
 2. L1 (half resolution) and L0 (full resolution): +-2 refinements.
 3. The reference of least full-pel cost plus (lam_me * r + 0.5).
 4. Per reference: a +-2 refinement with the MV rate taken against the
    median of the left / up / up-right neighbours' MVs; then, for every
    reference at once, the exact 7 x 7 quarter-pel step
    (ops/me_subpel.subpel_search).

Every cost adds the MV rate (quote_vlc table 10) times lam_me, rounded as
(lam_me * bits + 0.5) truncated: lam_me is a float32 and the product and
the sum are float32, as in thor_tpu; a float64 rate diverges. A tie keeps
the first candidate in thor_tpu's order (displacement, offset or reference),
which is what torch.argmin returns.

The TPU version gathers its windows with rolls and unrolls its candidate
loops; here each candidate set is one batched tensor (ops/windowed for the
windows) and its argmin, but for the quarter-pel step: on a CUDA tensor
it is the hand-written kernel csrc/me_subpel.cu, one launch a block size
for every reference, which scores each block's 49 candidates from its
window in shared memory; on a CPU tensor its plain version
(ops/me_subpel._subpel), reference by reference. Both give the same
integers.
"""

from __future__ import annotations

import torch

from ..ops.kernels import build_luma_mc_lut
from ..ops.me_subpel import PAD, _first_min, _mv_bits, _rate, subpel_search
from ..ops.windowed import banded_windows

L2_RANGE = 8        # +-8 quarter-resolution pixels = +-32 full-pel
# window-offset bounds per stage (L2 +-8 doubles per level, +-2 a pass)
M_L1 = 2 * L2_RANGE + 2                  # 18
M_L0 = 2 * (2 * L2_RANGE + 2) + 2        # 38
M_SEL = M_L0 + 2                         # 40 (me_subpel.M_SUB)
BIG = 1 << 30

I32 = torch.int32


def _down2(p):
    """2x2 box downscale, (sum + 2) >> 2 (common/temporal_interp.c:151)."""
    h, w = p.shape[-2] // 2, p.shape[-1] // 2
    q = p.reshape(*p.shape[:-2], h, 2, w, 2)
    return (q.sum(dim=(-3, -1), dtype=I32) + 2) >> 2


def _blocks4(plane, b, HB, WB):
    """[HB*b, WB*b] -> [HB, WB, b, b]."""
    return plane[:HB * b, :WB * b].reshape(HB, b, WB, b).permute(0, 2, 1, 3)


def _offset_sads(win, ob, b, rr):
    """[(2rr+1)^2, HB, WB] SADs of ob against win at every offset (dy
    major): win [HB, WB, b+2rr, b+2rr], ob [HB, WB, b, b] int32."""
    n = 2 * rr + 1
    view = win.to(I32).unfold(2, b, 1).unfold(3, b, 1)  # [HB,WB,n,n,b,b]
    sad = (ob[:, :, None, None] - view).abs().sum(dim=(4, 5), dtype=I32)
    return sad.permute(2, 3, 0, 1).reshape(n * n, *ob.shape[:2])


def _refine(ob, refp, padL, mvy, mvx, b, rr, lam_me, M, rate_of):
    """One +-rr full-pel pass of the current level: the best offset by SAD
    plus rate_of(mvx', mvy') over the candidate MVs. Returns (mvy, mvx,
    cost), each [HB, WB]."""
    win = banded_windows(refp, mvy - rr, mvx - rr, padL, padL, b,
                         b + 2 * rr, M)
    sad = _offset_sads(win, ob, b, rr)
    off = torch.arange(-rr, rr + 1, device=ob.device, dtype=I32)
    cy = mvy + off.repeat_interleave(2 * rr + 1)[:, None, None]
    cx = mvx + off.repeat(2 * rr + 1)[:, None, None]
    best, i = _first_min(sad + _rate(lam_me, rate_of(cx, cy)))
    return cy.gather(0, i[None].long())[0], cx.gather(0, i[None].long())[0], \
        best


def _med3(a, b, c):
    return a + b + c - torch.maximum(a, torch.maximum(b, c)) \
        - torch.minimum(a, torch.minimum(b, c))


def _pred_field(g):
    """Median of the left / up / up-right neighbours' MVs of an [HB, WB]
    field (zero outside the frame): the search's stand-in for get_mv_pred."""
    z = torch.zeros_like(g)
    left = torch.cat([z[:, :1], g[:, :-1]], 1)
    up = torch.cat([z[:1], g[:-1]], 0)
    upright = torch.cat([z[:1], torch.cat([g[:-1, 1:], z[:-1, :1]], 1)], 0)
    return _med3(left, up, upright)


def _l2_search(o2c, r2, lam_me, grids):
    """Exhaustive +-8 search at quarter resolution. o2c: [H2c, W2c];
    r2: [R, Hp/4, Wp/4] int32. Returns {16, 32, 64: (best dy, best dx)},
    each [R, HB, WB]: the first displacement (dy major) of least SAD plus
    scale * (lam_me * bits(16 dx, 16 dy) + 0.5)."""
    dev = o2c.device
    H2c, W2c = o2c.shape
    R = r2.shape[0]
    n = 2 * L2_RANGE + 1
    lo = PAD // 4 - L2_RANGE
    d = torch.arange(-L2_RANGE, L2_RANGE + 1, device=dev, dtype=I32)
    best = {s: (torch.full((R, hb, wb), BIG, dtype=I32, device=dev),
                torch.zeros((R, hb, wb), dtype=I32, device=dev),
                torch.zeros((R, hb, wb), dtype=I32, device=dev))
            for s, (hb, wb) in grids.items()}
    for dy in range(-L2_RANGE, L2_RANGE + 1):
        y0 = PAD // 4 + dy
        band = r2[:, y0:y0 + H2c, lo:lo + W2c + n - 1]
        win = band.unfold(2, W2c, 1)                   # [R, H2c, n, W2c]
        ad = (o2c[None, :, None] - win).abs()
        hb, wb = grids[16]
        s16 = ad.reshape(R, hb, 4, n, wb, 4).sum(dim=(2, 5), dtype=I32)
        sums = {16: s16}
        for s, prev in ((32, 16), (64, 32)):
            hb, wb = grids[s]
            sums[s] = sums[prev][:, :2 * hb, :, :2 * wb] \
                .reshape(R, hb, 2, n, wb, 2).sum(dim=(2, 5), dtype=I32)
        radd = _rate(lam_me, _mv_bits(16 * d, torch.full_like(d, 16 * dy)))
        for s, sc in ((16, 1), (32, 4), (64, 16)):
            cost = sums[s] + sc * radd[None, None, :, None]
            m, i = _first_min(cost.permute(2, 0, 1, 3))
            bc, by, bx = best[s]
            better = m < bc
            best[s] = (torch.where(better, m, bc),
                       torch.where(better, dy, by),
                       torch.where(better, i - L2_RANGE, bx))
    return {s: (v[1], v[2]) for s, v in best.items()}


def me_frame(org, refpad, lam_me, seq_bipred: int = 0):
    """Per-size motion search of one frame.

    org: [H, W] uint8 or int32; refpad: [R, H+192, W+192] uint8 padded
    references; lam_me: float32 0-d tensor on the same device. Returns
    {size: (mvy, mvx, slot, cost, ref_mvy, ref_mvx)}: quarter-pel MVs of
    the best reference (visual domain, unfolded), its slot and cost, each
    [N] in raster order, and every reference's own best MV, [R, N]."""
    H, W = org.shape
    R = refpad.shape[0]
    HB16, WB16 = H // 16, W // 16
    grids = {16: (HB16, WB16), 32: (H // 32, W // 32), 64: (H // 64, W // 64)}
    lut = build_luma_mc_lut(seq_bipred)
    o = org.to(I32)
    r0 = refpad
    o1 = _down2(o)
    r1 = _down2(refpad.to(I32)).to(torch.uint8)
    o2, r2 = _down2(o1), _down2(r1.to(I32))
    l2 = _l2_search(o2[:HB16 * 4, :WB16 * 4], r2, lam_me, grids)

    out = {}
    for s in (8, 16, 32, 64):
        if s == 8:
            HB, WB = H // 8, W // 8
            dev = org.device
            py_ = torch.clamp(torch.arange(HB, device=dev) // 2, max=HB16 - 1)
            px_ = torch.clamp(torch.arange(WB, device=dev) // 2, max=WB16 - 1)
            bdy, bdx = l2[16]
            mv2y = bdy[:, py_][:, :, px_]
            mv2x = bdx[:, py_][:, :, px_]
        else:
            HB, WB = grids[s]
            mv2y, mv2x = l2[s]
        ob0 = _blocks4(o, s, HB, WB)
        ob1 = _blocks4(o1, s // 2, HB, WB)

        ref_mv = []
        for r in range(R):
            m1y, m1x, _ = _refine(
                ob1, r1[r], PAD // 2, 2 * mv2y[r], 2 * mv2x[r], s // 2, 2,
                lam_me, M_L1, lambda cx, cy: _mv_bits(8 * cx, 8 * cy))
            ref_mv.append(_refine(
                ob0, r0[r], PAD, 2 * m1y, 2 * m1x, s, 2, lam_me, M_L0,
                lambda cx, cy: _mv_bits(4 * cx, 4 * cy)))

        rsel = torch.arange(R, device=org.device, dtype=I32)
        cost = torch.stack([c for _, _, c in ref_mv]) \
            + _rate(lam_me, rsel)[:, None, None]
        _, slot = _first_min(cost)
        mfy = torch.stack([m for m, _, _ in ref_mv]).gather(
            0, slot[None].long())[0]
        mfx = torch.stack([m for _, m, _ in ref_mv]).gather(
            0, slot[None].long())[0]

        py = 4 * _pred_field(mfy)
        px = 4 * _pred_field(mfx)
        sel = [_refine(ob0, r0[r], PAD, m0y, m0x, s, 2, lam_me, M_SEL,
                       lambda cx, cy: _mv_bits(4 * cx - px, 4 * cy - py))
               for r, (m0y, m0x, _) in enumerate(ref_mv)]
        ry, rx, rc = subpel_search(
            ob0, refpad, lut, torch.stack([m for m, _, _ in sel]),
            torch.stack([m for _, m, _ in sel]), s, lam_me, py, px)
        qy, qx, qc = (v.gather(0, slot[None].long())[0]
                      for v in (ry, rx, rc))
        out[s] = (qy.reshape(-1), qx.reshape(-1), slot.reshape(-1),
                  qc.reshape(-1), ry.reshape(R, -1), rx.reshape(R, -1))
    return out
