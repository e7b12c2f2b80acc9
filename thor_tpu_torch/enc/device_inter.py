"""Batched inter-frame (P and B) encoder of the device encoder.

Counterpart of thor_tpu/enc/device_inter.py. Its device work runs either
stage by stage (this module, Encoder(fused=False), thor_tpu's per-stage
dispatch) or as the three programs of enc/fused.py, one CUDA graph each
per signature (Encoder(fused=True), the default: thor_tpu's fused
dispatch, where the final program also runs the in-loop filters). Per
frame:

 1. measure (device): ME (enc/device_me), then per block size the motion
    variants (the ME MV, the left and up-right neighbours' MVs, zero MV per
    reference and, with bipred, pairs of the per-reference MVs) and the
    trial coding of every variant: banded MC (ops/banded_mc), residual,
    transform, quantize, reconstruct; exact SSDs, coefficient bits and cbp
    per (variant, block). The variants run one after another, as in
    thor_tpu (batched, they blew up memory at 4K on the TPU). Then the
    intra mode search (enc/device_intra) with the inter quantizer.
 2. decide (host): the copied C walk (native/thor_decide.c) over the
    fetched cost maps, in coding order; with encoder_speed <= 1, the skip
    candidates the walk could not match are measured and the walk runs
    again (the second chance).
 3. final reconstruction (device): the decoder's block MC
    (ops/mc.mc_frame, kernel 2) over the decided leaves, the residual of
    the chosen coefficient banks, then the encoder's intra scan
    (ops/enc_intra.encode_scan, kernel 6, inter quantizer) over the intra
    leaves.
 4. emit (host): the copied C writers, which also fill the encoder's
    side-info map for the in-loop filters.

Every output is integer data and equals thor_tpu's. There is no fallback:
a failing C walk or emit, or a kernel that fails, raises.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..codec.blockdata import DeblockData, get_mv_skip
from ..codec.constants import (
    BETA_TABLE, CHROMA_QP, GDEQUANT_TABLE, MAX_BLOCK_SIZE, MODE_BIPRED,
    MODE_INTER, MODE_INTRA, MODE_MERGE, MODE_SKIP, PAD_C, PAD_Y, TC_TABLE,
    zigzag_for)
from ..dec.reconstruct import mc_luts
from ..native import decide_frame_native, emit_frame_native
from ..ops import kernels as K
from ..ops.banded_mc import M_CHROMA, M_LUMA, mc_pred_banded
from ..ops.coeff_bits import coeff_bits_batch
from ..ops.enc_intra import encode_scan
from ..ops.mc import build_mc_records, mc_frame
from ..utils.tracing import count_wait, span
from . import fused as FU
from .device_intra import (intra_split_decisions, scan_records,
                           search_intra_frame_dev, search_intra_frame_maps)
from .device_me import me_frame

SIZES = (8, 16, 32, 64)
K_EXTRA = 4             # second-chance variants per block
MEAS_KEYS = ("ssd_coded", "ssd_pred", "bits", "cbp_y", "cbp_u", "cbp_v",
             "ssd_tb", "bits_tb", "cbp_tb_y", "cbp_tb_u", "cbp_tb_v")
VAR_KEYS = ("mvy", "mvx", "slot", "mvy1", "mvx1", "slot1", "bi")

I32 = torch.int32


def _sync(dev):
    """Wait for the current stream of `dev`: a stage's time ends there,
    and frames on other streams go on. Counted on the CPU too."""
    count_wait()
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


# ---------------------------------------------------------------------------
# Measurement: motion variants and trial coding
# ---------------------------------------------------------------------------

def _neigh(a, HB, WB, di, dj):
    """[N] block field -> the value of the (di, dj)-offset neighbour of
    every block (0 past the frame's edges)."""
    g = a.reshape(HB, WB)
    out = torch.zeros_like(g)
    out[max(di, 0):HB + min(di, 0), max(dj, 0):WB + min(dj, 0)] = \
        g[max(-di, 0):HB + min(-di, 0), max(-dj, 0):WB + min(-dj, 0)]
    return out.reshape(-1)


def motion_variants(me, H, W, R, has_bi, bslot0, bslot1, sign, sign_bi):
    """Per size, the motion variants the trials code: {size: {key: [K, N]
    int32}} over VAR_KEYS, in the stream domain. Variants [0, 3 + R) are
    uni-predicted (the ME MV, its left and up-right neighbours' MVs, zero
    MV at each reference); with has_bi four bipred pairs follow (the
    per-reference MVs at bslot0 / bslot1, their two neighbours' pairs,
    zero-zero). sign, sign_bi: [R] int32 tensors, 1 where a reference's
    MVs fold (uni-prediction, bipred)."""
    out = {}
    for s in SIZES:
        HB, WB = H // s, W // s
        qy, qx, slot, _, ry, rx = me[s]
        # ME searches the reference planes as they are; fold to the stream
        # domain: uni MVs by their slot's sign, per-reference MVs by their
        # own slot's bipred sign (they feed only bipred variants)
        sg = sign[slot.long()] != 0
        mvy = torch.where(sg, -qy, qy)
        mvx = torch.where(sg, -qx, qx)
        sgb = sign_bi[:, None] != 0
        ry = torch.where(sgb, -ry, ry)
        rx = torch.where(sgb, -rx, rx)

        def nb(a, di, dj):
            return _neigh(a, HB, WB, di, dj)

        zero = torch.zeros_like(mvy)
        var = {"mvy": [mvy, nb(mvy, 0, 1), nb(mvy, 1, -1)] + [zero] * R,
               "mvx": [mvx, nb(mvx, 0, 1), nb(mvx, 1, -1)] + [zero] * R,
               "slot": [slot, nb(slot, 0, 1), nb(slot, 1, -1)]
               + [torch.full_like(slot, r) for r in range(R)]}
        K_uni = len(var["mvy"])
        for k in ("mvy1", "mvx1", "slot1", "bi"):
            var[k] = [zero] * K_uni
        if has_bi:
            pairs = [(ry[bslot0], rx[bslot0], ry[bslot1], rx[bslot1])]
            for di, dj in ((0, 1), (1, -1)):
                pairs.append(tuple(nb(a, di, dj) for a in pairs[0]))
            pairs.append((zero,) * 4)
            for y0, x0, y1, x1 in pairs:
                var["mvy"].append(y0)
                var["mvx"].append(x0)
                var["slot"].append(torch.full_like(slot, bslot0))
                var["mvy1"].append(y1)
                var["mvx1"].append(x1)
                var["slot1"].append(torch.full_like(slot, bslot1))
                var["bi"].append(torch.ones_like(mvy))
        out[s] = {k: torch.stack(v).to(I32) for k, v in var.items()}
    return out


def _blocks_of(plane, b, HB, WB):
    """[HB*WB, b, b] int32 tiles of the plane's full blocks, raster
    order."""
    return plane[:HB * b, :WB * b].to(I32).reshape(HB, b, WB, b) \
        .permute(0, 2, 1, 3).reshape(HB * WB, b, b)


def _quads(a, b2):
    """[N, 2*b2, 2*b2] -> [4N, b2, b2] in (block, k = 2*qi + qj) order."""
    return a.reshape(-1, 2, b2, 2, b2).permute(0, 1, 3, 2, 4) \
        .reshape(-1, b2, b2)


def _unquads(a, b2):
    """Inverse of _quads: [4N, b2, b2] -> [N, 2*b2, 2*b2]."""
    return a.reshape(-1, 2, 2, b2, b2).permute(0, 1, 3, 2, 4) \
        .reshape(-1, 2 * b2, 2 * b2)


def _plane_trial(ob, pred, b, qp, zz, fast, chroma):
    """Code [N, b, b] blocks against their prediction: (levels int16,
    cbp, coded SSD, prediction SSD, coefficient bits)."""
    resid = ob - pred
    coeff = K.fwd_transform_batch(resid, b, fast)
    q, cbp = K.quantize_fwd_batch(coeff, qp, b, False, zz, chroma)
    rec = K.recon_from_q(pred, q, b, qp)
    ssd_c = ((ob - rec) ** 2).sum(dim=(1, 2))
    ssd_p = (resid ** 2).sum(dim=(1, 2))
    bits = coeff_bits_batch(q, b, False, chroma)
    return q.to(torch.int16), cbp, ssd_c, ssd_p, bits


def _plane_trial_tb(ob, pred, b, qp, zz, fast, chroma):
    """The trial with the transform split into four b/2 quadrants: (levels
    int16 in the quadrant layout, [N] 4-bit cbp mask with quadrant k at bit
    3 - k, SSD, bits), the SSD and bits of each quadrant counted as its
    cbp says."""
    b2 = b // 2
    oq, pq = _quads(ob, b2), _quads(pred, b2)
    q, cq, ssd_c, ssd_p, bq = _plane_trial(oq, pq, b2, qp, zz, fast, chroma)
    cq = cq.reshape(-1, 4)
    ssd = torch.where(cq, ssd_c.reshape(-1, 4), ssd_p.reshape(-1, 4)).sum(1)
    bits = torch.where(cq, bq.reshape(-1, 4), 0).sum(1)
    w = K.const(np.array([8, 4, 2, 1], np.int32), ob.device)
    mask = (cq.to(I32) * w).sum(1, dtype=I32)
    return _unquads(q, b2), mask, ssd, bits


def trial_coding(org, refs, var, s, qpY, qpC, sign, sign_bi, *, fastY,
                 fastC, tb, fastY2, luts, k_bi):
    """Code every full s x s block at every motion variant of `var`
    ({key: [K, N]}, VAR_KEYS). org: (y, u, v) planes; refs: (Y, U, V)
    [R, Hp, Wp] uint8 padded stacks; luts: numpy (luma [16, 6, 6], chroma
    [64, 4, 4]); variants from k_bi on may be bipred (the rest are not, by
    construction). Returns {key: [K, ...]}: the levels qy / qu / qv
    (int16), cbp_y / u / v, ssd_coded (the SSD of the planes as their cbp
    codes them), ssd_pred, bits (of the coded planes) and, with tb, the
    same for the split transform (qy_tb ..., cbp_tb_* masks, ssd_tb,
    bits_tb)."""
    H, W = org[0].shape
    HB, WB = H // s, W // s
    sc = s // 2
    zzy, zzc = zigzag_for(min(s, 16)), zigzag_for(min(sc, 16))
    obY = _blocks_of(org[0], s, HB, WB)
    obC = torch.cat([_blocks_of(p, sc, HB, WB) for p in org[1:]])
    N = HB * WB

    def predict(mvy, mvx, slot):
        m2 = [a.reshape(HB, WB) for a in (slot, mvy, mvx)]
        pY = mc_pred_banded(refs[0], *m2, luts[0], PAD_Y, 2, s, -2, M_LUMA)
        pC = [mc_pred_banded(r, *m2, luts[1], PAD_C, 3, sc, -1, M_CHROMA)
              for r in refs[1:]]
        return pY.reshape(-1, s, s), torch.cat([p.reshape(-1, sc, sc)
                                                for p in pC])

    outs = []
    for k in range(var["mvy"].shape[0]):
        bflag = var["bi"][k] != 0
        slot0 = var["slot"][k].long()
        sg0 = torch.where(bflag, sign_bi[slot0], sign[slot0]) != 0
        pY, pC = predict(torch.where(sg0, -var["mvy"][k], var["mvy"][k]),
                         torch.where(sg0, -var["mvx"][k], var["mvx"][k]),
                         var["slot"][k])
        if k >= k_bi:
            sg1 = sign_bi[var["slot1"][k].long()] != 0
            pY1, pC1 = predict(
                torch.where(sg1, -var["mvy1"][k], var["mvy1"][k]),
                torch.where(sg1, -var["mvx1"][k], var["mvx1"][k]),
                var["slot1"][k])
            pY = torch.where(bflag[:, None, None], (pY + pY1) >> 1, pY)
            bC = torch.cat([bflag, bflag])[:, None, None]
            pC = torch.where(bC, (pC + pC1) >> 1, pC)

        qy, cy, scy, spy, by = _plane_trial(obY, pY, s, qpY, zzy, fastY,
                                            False)
        qc, cc, scc, spc, bc = _plane_trial(obC, pC, sc, qpC, zzc, fastC,
                                            True)
        cu, cv = cc[:N], cc[N:]
        out = dict(
            qy=qy, qu=qc[:N], qv=qc[N:], cbp_y=cy, cbp_u=cu, cbp_v=cv,
            ssd_coded=(torch.where(cy, scy, spy)
                       + torch.where(cu, scc[:N], spc[:N])
                       + torch.where(cv, scc[N:], spc[N:])),
            ssd_pred=spy + spc[:N] + spc[N:],
            bits=(torch.where(cy, by, 0) + torch.where(cu, bc[:N], 0)
                  + torch.where(cv, bc[N:], 0)).to(I32))
        if tb:
            zy2, zc2 = zigzag_for(min(s // 2, 16)), zigzag_for(min(sc // 2,
                                                                   16))
            qty, mty, sty, bty = _plane_trial_tb(obY, pY, s, qpY, zy2,
                                                 fastY2, False)
            qtc, mtc, stc, btc = _plane_trial_tb(obC, pC, sc, qpC, zc2,
                                                 fastC, True)
            out.update(qy_tb=qty, qu_tb=qtc[:N], qv_tb=qtc[N:],
                       cbp_tb_y=mty, cbp_tb_u=mtc[:N], cbp_tb_v=mtc[N:],
                       ssd_tb=sty + stc[:N] + stc[N:],
                       bits_tb=(bty + btc[:N] + btc[N:]).to(I32))
        outs.append(out)
    return {key: torch.stack([o[key] for o in outs]) for key in outs[0]}


def trial_flags(speed, tb_split, s):
    """(fastY, fastC, tb, fastY2) of size s at encoder_speed `speed` and
    enable_tb_split `tb_split`."""
    fast32, fast64 = speed > 1, speed > 0
    return dict(fastY=(s == 64 and fast64) or fast32, fastC=fast32,
                tb=tb_split == 1 and s > 8, fastY2=s == 64 or fast32)


def _trial_flags(p, s):
    """trial_flags under EncoderParams p."""
    return trial_flags(p.encoder_speed, p.enable_tb_split, s)

# ---------------------------------------------------------------------------
# Host decision walk (the C copy) and its glue
# ---------------------------------------------------------------------------

class Leaf:
    """One decided leaf: position and size, mode, list-0 MV / reference,
    skip index, intra mode, the measured (variant k, block idx) whose banks
    it codes when use_cbp, list 1 and direction, tb-split residual."""
    __slots__ = ("ypos", "xpos", "size", "mode", "mv", "ref", "skip_idx",
                 "intra_mode", "idx", "use_cbp", "k", "mv1", "ref1", "dir",
                 "tb")

    def __init__(self, ypos, xpos, size, mode, mv=(0, 0), ref=0,
                 skip_idx=0, intra_mode=0, idx=0, use_cbp=False, k=0,
                 mv1=(0, 0), ref1=0, dir=0, tb=0):
        self.ypos, self.xpos, self.size = ypos, xpos, size
        self.mode, self.mv, self.ref = mode, mv, ref
        self.skip_idx, self.intra_mode = skip_idx, intra_mode
        self.idx, self.use_cbp, self.k = idx, use_cbp, k
        self.mv1, self.ref1, self.dir, self.tb = mv1, ref1, dir, tb


def decide_frame(enc, meas, intra_modes, intra_costs, lam, lam_me):
    """The bottom-up quadtree decision walk in coding order
    (enc/encode_block.c:2787-3033's recursion over the measured cost maps)
    through the C copy. meas: {size: host maps}; returns the leaves in
    coding order."""
    p = enc.params
    per_size = []
    for s in SIZES:
        d = {k: v for k, v in meas[s].items() if k != "bi"}
        d.update(intra_cost=intra_costs[s], intra_mode=intra_modes[s])
        per_size.append(d)
    recs = decide_frame_native(
        enc.width, enc.height, enc.num_ref, int(p.enable_bipred),
        int(enc.interp_ref), int(bool(p.use_block_contexts)),
        int(enc.frame_type), float(lam), float(lam_me), per_size)
    return [Leaf(r.ypos, r.xpos, r.size, r.mode, mv=(r.mvx, r.mvy),
                 ref=r.ref, skip_idx=r.skip_idx, intra_mode=r.intra_mode,
                 idx=r.idx, use_cbp=bool(r.use_cbp), k=r.k,
                 mv1=(r.mv1x, r.mv1y), ref1=r.ref1, dir=r.dir, tb=int(r.tb))
            for r in recs]


def store_leaf_dd(dd, lf, m):
    """Store one decided leaf into a side-info map as the walk and the
    emit do (the C walk keeps its own map, so a replay uses this)."""
    s, idx = lf.size, lf.idx
    if lf.mode == MODE_INTRA:
        mv4 = ((0, 0),) * 4
        dd.store_block(lf.ypos, lf.xpos, s, s, s, MODE_INTRA, (1, 1, 1), 0, 0,
                       mv4, mv4, 0, 0, -1)
        return
    cbp = (0, 0, 0)
    if lf.use_cbp:
        if lf.tb:
            cbp = tuple(int(m[f"cbp_tb_{c}"][lf.k, idx] != 0) for c in "yuv")
        else:
            cbp = tuple(int(m[f"cbp_{c}"][lf.k, idx]) for c in "yuv")
    if lf.mode in (MODE_SKIP, MODE_MERGE):
        dd.store_block(lf.ypos, lf.xpos, s, s, s, lf.mode, cbp, 0, 0,
                       (lf.mv,) * 4, (lf.mv1,) * 4, lf.ref, lf.ref1, lf.dir)
    elif lf.mode == MODE_INTER:
        dd.store_block(lf.ypos, lf.xpos, s, s, s, MODE_INTER, cbp, lf.tb, 0,
                       (lf.mv,) * 4, ((0, 0),) * 4, lf.ref, 0, 0)
    else:
        dd.store_block(lf.ypos, lf.xpos, s, s, s, MODE_BIPRED, cbp, 0, 0,
                       (lf.mv,) * 4, (lf.mv1,) * 4, lf.ref, lf.ref1, 2)


def collect_missing(W, H, leaves, meas):
    """Replay the leaves in coding order over a fresh side-info map and
    return, per size, {block idx: [(mvx, mvy, ref), ...]}: the uni skip
    candidates no measured uni variant matches. Skip candidates are decided
    MVs carried along skip chains (common/inter_prediction.c:331-348), so
    the first measurement misses those that began elsewhere."""
    dd = DeblockData(W, H)
    missing = {s: {} for s in SIZES}
    for lf in leaves:
        m = meas[lf.size]
        K_uni, idx = m["K_uni"], lf.idx
        mvx, mvy, slt = (m[k][:K_uni, idx] for k in ("mvx", "mvy", "slot"))
        for c in get_mv_skip(lf.ypos, lf.xpos, W, H, lf.size, dd):
            if c.bipred_flag == 2:
                continue
            if ((mvx == c.mv0x) & (mvy == c.mv0y)
                    & (slt == c.ref_idx0)).any():
                continue
            lst = missing[lf.size].setdefault(idx, [])
            if (c.mv0x, c.mv0y, c.ref_idx0) not in lst:
                lst.append((c.mv0x, c.mv0y, c.ref_idx0))
        store_leaf_dd(dd, lf, m)
    return missing


def extra_variants(missing, H, W):
    """{size: [K_EXTRA, N] (mvy, mvx, slot) numpy} of the second chance:
    each block's first K_EXTRA missing candidates, zero beyond them."""
    ev = {}
    for s in SIZES:
        N = (H // s) * (W // s)
        ey, ex, es = (np.zeros((K_EXTRA, N), np.int32) for _ in range(3))
        for idx, lst in missing[s].items():
            for j, (mx, my, r0) in enumerate(lst[:K_EXTRA]):
                ex[j, idx], ey[j, idx], es[j, idx] = mx, my, r0
        ev[s] = (ey, ex, es)
    return ev


def _insert(a, b, K_uni):
    """[uni | extra | bi] along the variant axis (numpy or torch)."""
    if isinstance(a, torch.Tensor):
        return torch.cat([a[:K_uni], b.to(a.dtype), a[K_uni:]])
    return np.concatenate([a[:K_uni], np.asarray(b).astype(a.dtype),
                           a[K_uni:]])


def splice_extra(ctx, ev, s, p):
    """Code the second chance's variants `ev` ({key: [K_EXTRA, N]}, VAR_KEYS,
    on the device) at size s and splice their banks into ctx["trials"][s]
    in [uni | extra | bi] order. Returns the new banks."""
    t2 = trial_coding(ctx["org"], ctx["refs"], ev, s, ctx["qpY"], ctx["qpC"],
                      ctx["sign"], ctx["sign_bi"], luts=ctx["luts_np"],
                      k_bi=K_EXTRA, **_trial_flags(p, s))
    ctx["trials"][s] = {k: _insert(a, t2[k], ctx["K_uni"])
                        for k, a in ctx["trials"][s].items()}
    return t2


def second_chance(enc, ctx, meas, leaves):
    """Measure the first walk's unmatched skip candidates and splice them
    into the host maps and the device banks in [uni | extra | bi] order
    (and into the frame's record, when it has one). Returns False when
    nothing was missing."""
    W, H = enc.width, enc.height
    missing = collect_missing(W, H, leaves, meas)
    if not any(missing[s] for s in SIZES):
        return False
    p = enc.params
    dev = ctx["org"][0].device
    rec = ctx.get("rec")
    for s, (ey, ex, es) in extra_variants(missing, H, W).items():
        z = np.zeros_like(ey)
        ev = {k: torch.from_numpy(a).to(dev) for k, a in zip(
            VAR_KEYS, (ey, ex, es, z, z, z, z))}
        if rec is not None:
            rec["extra"][s] = ev
        t2 = splice_extra(ctx, ev, s, p)
        m = meas[s]
        K_uni = m["K_uni"]
        host = {k: t2[k].cpu().numpy() for k in MEAS_KEYS if k in t2}
        for k, a in zip(VAR_KEYS, (ey, ex, es, z, z, z, z)):
            m[k] = _insert(m[k], a, K_uni)
        for k, a in host.items():
            m[k] = _insert(m[k], a, K_uni)
        m["K_uni"] = K_uni + K_EXTRA
    return True


# ---------------------------------------------------------------------------
# Final reconstruction
# ---------------------------------------------------------------------------

def inter_pus(leaves, sign, sign_bi):
    """The inter leaves as MC prediction units of ops/mc.build_mc_records
    (luma coordinates, MVs folded to the visual domain as the decoder folds
    them: list 0 by the bipred sign on a bipred leaf, else by the uni sign;
    list 1 by the bipred sign), and the number of (leaf, list, plane)
    windows whose origin thor_tpu's banded MC would clamp to +-M_LUMA /
    +-M_CHROMA. sign, sign_bi: numpy [R]."""
    lv = [lf for lf in leaves if lf.mode != MODE_INTRA]
    a = np.array([(lf.ypos, lf.xpos, lf.size, lf.mv[0], lf.mv[1], lf.ref,
                   lf.mv1[0], lf.mv1[1], lf.ref1, lf.dir == 2)
                  for lf in lv], np.int64).reshape(-1, 10)
    bi = a[:, 9]
    s0 = np.where(bi != 0, sign_bi[a[:, 5]], sign[a[:, 5]]) != 0
    s1 = (sign_bi[a[:, 8]] != 0) & (bi != 0)
    pus = {"y0": a[:, 0], "x0": a[:, 1], "h": a[:, 2], "w": a[:, 2],
           "slot0": a[:, 5], "mvx0": np.where(s0, -a[:, 3], a[:, 3]),
           "mvy0": np.where(s0, -a[:, 4], a[:, 4]), "bi": bi,
           "slot1": np.where(bi != 0, a[:, 8], 0),
           "mvx1": np.where(s1, -a[:, 6], a[:, 6]),
           "mvy1": np.where(s1, -a[:, 7], a[:, 7])}
    clamped = 0
    for mx, my, on in (("mvx0", "mvy0", np.ones_like(bi, bool)),
                       ("mvx1", "mvy1", bi != 0)):
        for fb, lo, M in ((2, -2, M_LUMA), (3, -1, M_CHROMA)):
            far = ((np.abs((pus[mx] >> fb) + lo) > M)
                   | (np.abs((pus[my] >> fb) + lo) > M))
            clamped += int((far & on).sum())
    return pus, clamped


def _chosen_levels(t, c, tb, ks, idx, b):
    """The levels one plane (c: y, u, v) of the chosen trial banks codes
    for the blocks (variant ks, block idx) of one group, all coded and all
    tb-split or none: [M, b', b'] int32 rows with the levels under a clear
    cbp zeroed, b' = b, or b / 2 for the four quadrants (k = 2 * qi + qj)
    of a tb-split block, whose cbp is bit 3 - k of the block's mask."""
    if not tb:
        q = t[f"q{c}"][ks, idx].to(I32)
        return torch.where(t[f"cbp_{c}"][ks, idx][:, None, None], q, 0)
    b2 = b // 2
    q = _quads(t[f"q{c}_tb"][ks, idx].to(I32), b2)
    bit = K.const(np.array([3, 2, 1, 0], np.int32), ks.device)
    cb = (((t[f"cbp_tb_{c}"][ks, idx][:, None] >> bit) & 1) != 0).reshape(-1)
    return torch.where(cb[:, None, None], q, 0)


def _add_residual(plane, q, b, qp, ys, xs):
    """Dequantize and inverse-transform [M, b, b] level rows and add them
    at their b-aligned origins (ys, xs: [M] tensors) to the plane. A 64x64
    block inverse-transforms its low 32x32 with the 64-block dequant shift
    and repeats every sample 2x2."""
    dev = plane.device
    sh = int(math.log2(b)) - 1
    sy = 32 if b == 64 else b
    M = q.shape[0]
    fac = int(GDEQUANT_TABLE[qp % 6]) << (qp // 6)
    vals = K.residual_group(
        q[:, :sy, :sy], torch.full((M,), fac, dtype=I32, device=dev),
        torch.full((M,), 1 << (sh - 1), dtype=I32, device=dev),
        torch.full((M,), sh, dtype=I32, device=dev), sy)
    if sy != b:
        vals = vals.repeat_interleave(2, 1).repeat_interleave(2, 2)
    return K.scatter_tu(plane, vals, ys, xs)


def mc_records(leaves, sign, sign_bi, H, W):
    """The MC records (ops/mc) of the inter leaves: (luma, chroma) numpy
    record arrays and the PU count. sign, sign_bi: numpy [R]. Raises when
    a window would leave the range where the decoder's MC and thor_tpu's
    banded MC agree."""
    pus, clamped = inter_pus(leaves, sign, sign_bi)
    recs_y, ny = build_mc_records(pus, H, W, PAD_Y, 2, -2, 6)
    pus_c = dict(pus)
    for k in ("y0", "x0", "h", "w"):
        pus_c[k] = pus[k] // 2
    recs_c, nc = build_mc_records(pus_c, H // 2, W // 2, PAD_C, 3, -1, 4)
    if clamped or ny or nc:
        # the device ME bounds every MV the walk can pick, so no window
        # leaves the range where the decoder's MC and thor_tpu's agree
        raise RuntimeError(
            f"final MC: {clamped} windows past thor_tpu's clamp and "
            f"{ny + nc} past the padded planes")
    return recs_y, recs_c, len(pus["y0"])


def final_plan(leaves, sign, sign_bi, H, W, dev):
    """What the final reconstruction reads of the decided leaves, on `dev`:
    {"mc_y", "mc_c": the MC records of the inter leaves (ops/mc), "npu":
    their PU count, "groups": per (size, tb) of the coded inter leaves
    (s, tb, variants ks, blocks idx, luma (ys, xs), chroma (ys, xs)),
    "intra": the scan records (luma, chroma) of the intra leaves or None}.
    sign, sign_bi: numpy [R]. The host work of the final step; a replay
    runs final_frame on a recorded plan."""
    recs_y, recs_c, npu = mc_records(leaves, sign, sign_bi, H, W)

    def dev_t(a, dtype=torch.long):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    groups = []
    for s in SIZES:
        coded = [lf for lf in leaves if lf.mode != MODE_INTRA and lf.use_cbp
                 and lf.size == s]
        for tb in (False, True):
            sel = [lf for lf in coded if bool(lf.tb) == tb]
            if not sel:
                continue
            pos = []
            for div in (1, 2):
                y0 = np.array([lf.ypos // div for lf in sel], np.int64)
                x0 = np.array([lf.xpos // div for lf in sel], np.int64)
                if tb:      # the quadrants' origins, k = 2 * qi + qj
                    b2 = s // div // 2
                    y0 = (y0[:, None] + np.array([0, 0, 1, 1]) * b2) \
                        .reshape(-1)
                    x0 = (x0[:, None] + np.array([0, 1, 0, 1]) * b2) \
                        .reshape(-1)
                pos.append((dev_t(y0), dev_t(x0)))
            groups.append((s, tb, dev_t([lf.k for lf in sel]),
                           dev_t([lf.idx for lf in sel]), *pos))
    intra = [lf for lf in leaves if lf.mode == MODE_INTRA]
    scan = None
    if intra:
        scan = tuple(dev_t(r, I32) for r in scan_records(
            [(lf.ypos, lf.xpos, lf.size, lf.intra_mode) for lf in intra],
            W, H))
    return {"mc_y": dev_t(recs_y, I32), "mc_c": dev_t(recs_c, I32),
            "npu": npu, "groups": groups, "intra": scan}


def final_frame(refs, org, trials, plan, qpY, qpC, luts, fast, H, W):
    """The final reconstruction on the device: the decoder's block MC
    (ops/mc.mc_frame, kernel 2) of the inter leaves plus the residual of
    their chosen banks, clipped, then the encoder's intra scan
    (ops/enc_intra.encode_scan, kernel 6, inter quantizer) over the intra
    leaves. refs: (Y, U, V) [R, Hp, Wp] uint8; org: the int32 planes;
    trials: {size: device banks}; plan: final_plan's; luts: the [P, T*T]
    int32 LUT tensors of ops/mc. Returns the (y, u, v) int32 planes and
    the scan's level banks (luma [M, 1, 16, 16], chroma [M, 2, 16, 16];
    None without intra leaves). The host does not wait."""
    dev = refs[0].device
    py = mc_frame(refs[0][None].contiguous(), plan["mc_y"], luts[0], H, W)[0]
    puv = mc_frame(torch.stack(refs[1:]).contiguous(), plan["mc_c"], luts[1],
                   H // 2, W // 2)
    rs = [torch.zeros((H, W), dtype=I32, device=dev)] + [
        torch.zeros((H // 2, W // 2), dtype=I32, device=dev) for _ in "uv"]
    for s, tb, ks, idx, pos_y, pos_c in plan["groups"]:
        for j, c in enumerate("yuv"):
            b, qp = (s, qpY) if c == "y" else (s // 2, qpC)
            q = _chosen_levels(trials[s], c, tb, ks, idx, b)
            rs[j] = _add_residual(rs[j], q, b // 2 if tb else b, qp,
                                  *(pos_y if c == "y" else pos_c))
    y, u, v = (K.clip255(py + rs[0]), K.clip255(puv[0] + rs[1]),
               K.clip255(puv[1] + rs[2]))
    if plan["intra"] is None:
        return y, u, v, None, None
    recs_y, recs_c = plan["intra"]
    y, q16y = encode_scan(y[None].contiguous(), org[0][None], recs_y, qpY,
                          fast, False)
    uv, q16c = encode_scan(torch.stack([u, v]), torch.stack(org[1:]), recs_c,
                           qpC, fast, False)
    return y[0], uv[0], uv[1], q16y, q16c


# ---------------------------------------------------------------------------
# Emission (the C copy)
# ---------------------------------------------------------------------------

def emit_frame(enc, w, leaves, meas, coeff_host, intra_q):
    """Write the frame's superblock payload through the C writers into
    `w`; they re-derive skip candidates, contexts and MV predictors from
    their own side-info walk and fill enc.deblock_data as
    store_deblock_data does. coeff_host: {size: {qy, qu, qv, index}} of the
    coded leaves; intra_q: {qy, qu, qv, cy, cu, cv, index} of the intra
    leaves."""
    p = enc.params
    banks = []
    for s in SIZES:
        ch = coeff_host.get(s)
        banks.append({c: ch[c] if ch else np.zeros((0, b, b), np.int16)
                      for c, b in (("qy", s), ("qu", s // 2),
                                   ("qv", s // 2))})
        banks[-1].update(ydim=s, cdim=s // 2)
    zi = np.zeros((0, 16, 16), np.int16)
    banks.append({"qy": intra_q.get("qy", zi), "qu": intra_q.get("qu", zi),
                  "qv": intra_q.get("qv", zi), "ydim": 16, "cdim": 16})
    n = len(leaves)
    bank_row = np.zeros(n, np.int32)
    cbp3 = np.zeros(n, np.int32)
    for i, lf in enumerate(leaves):
        if lf.mode == MODE_INTRA:
            j = intra_q["index"][(lf.ypos, lf.xpos)]
            bank_row[i] = j
            cbp3[i] = (int(intra_q["cy"][j]) | (int(intra_q["cu"][j]) << 1)
                       | (int(intra_q["cv"][j]) << 2))
        elif lf.use_cbp:
            bank_row[i] = coeff_host[lf.size]["index"][(lf.ypos, lf.xpos)]
            m = meas[lf.size]
            if lf.tb:       # the three 4-bit quadrant masks
                cbp3[i] = (int(m["cbp_tb_y"][lf.k, lf.idx])
                           | (int(m["cbp_tb_u"][lf.k, lf.idx]) << 4)
                           | (int(m["cbp_tb_v"][lf.k, lf.idx]) << 8))
            else:
                cbp3[i] = (int(m["cbp_y"][lf.k, lf.idx])
                           | (int(m["cbp_u"][lf.k, lf.idx]) << 1)
                           | (int(m["cbp_v"][lf.k, lf.idx]) << 2))
    params = {"W": enc.width, "H": enc.height, "num_ref": enc.num_ref,
              "enable_bipred": int(p.enable_bipred),
              "interp_ref": int(enc.interp_ref),
              "use_block_contexts": int(bool(p.use_block_contexts)),
              "num_intra_modes": enc.num_intra_modes,
              "max_num_tb_part": 2 if p.enable_tb_split == 1 else 1,
              "max_num_pb_part": 4 if p.enable_pb_split else 1,
              "max_delta_qp": int(p.max_delta_qp),
              "frame_type": int(enc.frame_type)}
    emit_frame_native(w, params, leaves, bank_row, cbp3, banks,
                      enc.deblock_data)


def gather_coeffs(leaves, trials):
    """Host copies of the coded leaves' levels, per size in leaf order:
    {size: {qy, qu, qv, index}}; a tb leaf carries its quadrant banks."""
    out = {}
    for s in SIZES:
        lst = [lf for lf in leaves if lf.mode != MODE_INTRA and lf.use_cbp
               and lf.size == s]
        if not lst:
            continue
        t = trials[s]
        dev = t["qy"].device
        ks = torch.tensor([lf.k for lf in lst], dtype=torch.long, device=dev)
        sel = torch.tensor([lf.idx for lf in lst], dtype=torch.long,
                           device=dev)
        tbm = torch.tensor([bool(lf.tb) for lf in lst], device=dev)
        g = {}
        for c in ("qy", "qu", "qv"):
            q = t[c][ks, sel]
            if any(lf.tb for lf in lst):
                q = torch.where(tbm[:, None, None], t[c + "_tb"][ks, sel], q)
            g[c] = q.cpu().numpy()
        g["index"] = {(lf.ypos, lf.xpos): i for i, lf in enumerate(lst)}
        out[s] = g
    return out


# ---------------------------------------------------------------------------
# Frame driver
# ---------------------------------------------------------------------------

def _measure(org, refs, R, K_uni, has_bi, bslot0, bslot1, sign, sign_bi,
             lam_me, qpY, qpC, p, luts_np, times=None):
    """ME, the motion variants and the trials of every size on the device:
    (variants, trials). With `times`, "me" and "trials" get the host-clock
    seconds of each, ended by a wait for the device."""
    dev = org[0].device
    H, W = org[0].shape
    with span("enc.me", times, "me"):
        me = me_frame(org[0], refs[0], lam_me, int(p.enable_bipred))
        variants = motion_variants(me, H, W, R, has_bi, bslot0, bslot1,
                                   sign, sign_bi)
        if times is not None:
            _sync(dev)
    with span("enc.trials", times, "trials"):
        trials = {s: trial_coding(org, refs, variants[s], s, qpY, qpC, sign,
                                  sign_bi, luts=luts_np, k_bi=K_uni,
                                  **_trial_flags(p, s)) for s in SIZES}
        if times is not None:
            _sync(dev)
    return variants, trials


def _ref_key(enc, i, ref):
    """A reference's identity in a record: ("i", n) for the interpolated
    reference of frame n, ("r", n) for the window's frame n."""
    return ("i" if enc.ref_array[i] < 0 else "r", ref.frame_num)


def measure_inter_frame_device(enc, org_y, org_u, org_v):
    """First half of a P/B frame: ME, motion variants, the trials of every
    size and the intra search, on the encoder's device. org_*: int32
    planes there. Returns the context finish_inter_frame_device drains.
    On the fused path (enc.fused) they are one program (enc/fused.py) and
    enc.frame_times[-1] gets "measure", its host-clock seconds up to the
    fetch of the cost maps; stage by stage it gets "me", "trials" and
    "intra_search", each ended by a wait for the device. On an
    Encoder(record=True) the context carries the frame's record (see
    replay_device_frame)."""
    W, H = enc.width, enc.height
    p = enc.params
    dev = org_y.device
    times = enc.frame_times[-1]
    qpY = enc.frame_qp
    qpC = int(CHROMA_QP[qpY])
    lam = enc.lambda_
    lam_me = math.sqrt(lam)
    R = enc.num_ref
    refs = [enc.get_ref(i) for i in range(R)]
    # the MV sign of each reference slot: MVs fold toward references shown
    # after this frame, frame_num > current for uni-prediction and >= for
    # bipred (the interpolated reference has the frame's own number)
    sign = np.array([int(r.frame_num > enc.frame_num) for r in refs],
                    np.int32)
    sign_bi = np.array([int(r.frame_num >= enc.frame_num) for r in refs],
                       np.int32)
    # bipred trials on bipred sequences with two references or more: list
    # 0 / 1 are slots (1, 2) on a B frame with the interpolated reference,
    # else (0, 1) (enc/encode_block.c:2115-2170)
    has_bi = bool(p.enable_bipred) and R > 1
    bslot0, bslot1 = (1, 2) if has_bi and enc.frame_type == 2 \
        and enc.interp_ref else (0, 1)
    K_uni = 3 + R
    org = (org_y, org_u, org_v)
    if enc.fused:
        ctx = FU.measure_frame(enc, org, refs, sign, sign_bi, has_bi, bslot0,
                               bslot1, qpY, qpC, lam, lam_me)
    else:
        refs_d = tuple(torch.stack([getattr(r, c) for r in refs])
                       for c in ("y", "u", "v"))
        sign_d = torch.from_numpy(sign).to(dev)
        sign_bi_d = torch.from_numpy(sign_bi).to(dev)
        lam_me_d = torch.tensor(lam_me, dtype=torch.float32, device=dev)
        luts_np = (K.build_luma_mc_lut(int(p.enable_bipred)),
                   K.build_chroma_mc_lut())
        variants, trials = _measure(org, refs_d, R, K_uni, has_bi, bslot0,
                                    bslot1, sign_d, sign_bi_d, lam_me_d, qpY,
                                    qpC, p, luts_np, times)
        with span("enc.intra_search", times, "intra_search"):
            intra = search_intra_frame_maps(org_y, org_u, org_v, qpY, qpC,
                                            lam, W, H, p.encoder_speed > 1,
                                            enc.num_intra_modes,
                                            intra_quant=False)
        ctx = dict(fused=False, org=org, refs=refs_d, variants=variants,
                   trials=trials, intra=intra, sign=sign_d,
                   sign_bi=sign_bi_d, sign_np=sign, sign_bi_np=sign_bi,
                   qpY=qpY, qpC=qpC, lam=lam, lam_me=lam_me, K_uni=K_uni,
                   luts_np=luts_np)
    if enc.device_record is not None:
        keys = [_ref_key(enc, i, r) for i, r in enumerate(refs)]
        # the references no recorded frame makes (the I frame, the
        # interpolated reference, a mirror frame), copied onto the record
        uploads = {}
        for k, r in zip(keys, refs):
            if k not in enc.record_keys:
                enc.record_keys.add(k)
                uploads[k] = tuple(getattr(r, c).clone() for c in "yuv")
        ctx["rec"] = dict(frame_num=enc.frame_num, H=H, W=W, org=org,
                          ref_keys=keys, uploads=uploads, fused=None)
        if not enc.fused:
            ctx["rec"].update(
                R=R, K_uni=K_uni, has_bi=has_bi, bslot0=bslot0,
                bslot1=bslot1, sign=ctx["sign"], sign_bi=ctx["sign_bi"],
                lam=lam, lam_me=lam_me_d, qpY=qpY, qpC=qpC, params=p,
                nmodes=enc.num_intra_modes, luts_np=ctx["luts_np"],
                extra={})
    return ctx


def _decide(enc, ctx, meas, intra):
    """The C walk over the host maps and, with encoder_speed <= 1, the
    second chance and the walk again: the leaves. Adds "decide" and
    "second_chance" to enc.frame_times[-1] (spans enc.decide and
    enc.second_chance, of it enc.second_chance.walk, the walk again)."""
    W, H = enc.width, enc.height
    times = enc.frame_times[-1]
    with span("enc.decide", times, "decide"):
        intra_modes, _, intra_costs = intra_split_decisions(
            intra, W, H, return_costs=True)
        leaves = decide_frame(enc, meas, intra_modes, intra_costs,
                              ctx["lam"], ctx["lam_me"])
    with span("enc.second_chance", times, "second_chance"):
        if enc.params.encoder_speed <= 1 and (
                FU.second_chance(enc, ctx, leaves) if ctx["fused"]
                else second_chance(enc, ctx, meas, leaves)):
            with span("enc.second_chance.walk"):
                leaves = decide_frame(enc, meas, intra_modes, intra_costs,
                                      ctx["lam"], ctx["lam_me"])
    return leaves


def finish_inter_frame_device(enc, w, ctx):
    """Second half: fetch the cost maps, run the C walk (and the second
    chance), reconstruct on the device (kernels 2 and 6) and emit through
    the C writers, which fill enc.deblock_data. Records "decide",
    "second_chance", "final" and "emit" in enc.frame_times[-1], with the
    counts "pus" (the MC's prediction units) and "intra_leaves"; on a
    recorded frame the record gets what its replay reads.

    Stage by stage it returns the unfiltered (y, u, v) int32 planes on
    the device. On the fused path the final program also ran the in-loop
    filters, and it returns enc/fused.finish_frame's dict: the filtered
    uint8 planes on the device and fetched, the padded reference planes
    and the CLPF decision per superblock."""
    if ctx["fused"]:
        try:
            leaves = _decide(enc, ctx, ctx["meas"], ctx["intra"])
            out = FU.finish_frame(enc, w, ctx, leaves)
        finally:
            FU.release(ctx)
        if ctx.get("rec") is not None:
            ctx["rec"]["fused"] = {k: ctx[k] for k in (
                "sig", "small", "extra", "fsig", "fbuf")}
        return out
    W, H = enc.width, enc.height
    p = enc.params
    times = enc.frame_times[-1]
    org, trials = ctx["org"], ctx["trials"]
    dev = org[0].device
    qpY, qpC = ctx["qpY"], ctx["qpC"]

    # the maps' fetch counts toward "decide"
    with span("enc.decide", times, "decide"):
        meas = {}
        for s in SIZES:
            meas[s] = {k: a.cpu().numpy()
                       for k, a in ctx["variants"][s].items()}
            meas[s].update({k: trials[s][k].cpu().numpy()
                            for k in MEAS_KEYS if k in trials[s]})
            meas[s]["K_uni"] = ctx["K_uni"]
    leaves = _decide(enc, ctx, meas, ctx["intra"])

    with span("enc.final", times, "final"):
        plan = final_plan(leaves, ctx["sign_np"], ctx["sign_bi_np"], H, W,
                          dev)
        y, u, v, q16y, q16c = final_frame(
            ctx["refs"], org, ctx["trials"], plan, qpY, qpC,
            mc_luts(int(p.enable_bipred), dev), p.encoder_speed > 1, H, W)
        if ctx.get("rec") is not None:
            ctx["rec"]["plan"] = plan
        intra = [lf for lf in leaves if lf.mode == MODE_INTRA]
        intra_q = {}
        if intra:
            q16c = q16c.cpu().numpy()
            intra_q = {"qy": q16y[:, 0].cpu().numpy(), "qu": q16c[:, 0],
                       "qv": q16c[:, 1]}
            # the zero-run pass never clears a level, so "any level
            # nonzero" is the quantizer's cbp
            for c in "yuv":
                intra_q["c" + c] = (intra_q["q" + c] != 0).any(axis=(1, 2))
            intra_q["index"] = {(lf.ypos, lf.xpos): i
                                for i, lf in enumerate(intra)}
        coeff_host = gather_coeffs(leaves, ctx["trials"])
    times["pus"] = plan["npu"]
    times["intra_leaves"] = len(intra)

    with span("enc.emit", times, "emit"):
        enc.deblock_data.reset()
        emit_frame(enc, w, leaves, meas, coeff_host, intra_q)
    return y, u, v


# ---------------------------------------------------------------------------
# Replay (utils/device_encode_fps.py)
# ---------------------------------------------------------------------------

def clpf_cand_masks(dd, H, W):
    """The CLPF candidate masks of a side-info map (numpy, thor_tpu's
    _clpf_cand_masks :919): per plane, the [H/8, W/8] cells inside whole
    superblocks whose block codes that plane and is not bipred."""
    SBH, SBW = H // MAX_BLOCK_SIZE, W // MAX_BLOCK_SIZE
    h8, w8 = SBH * 8, SBW * 8
    notbi = dd.mode != MODE_BIPRED
    out = []
    for cbp in (dd.cbp_y, dd.cbp_u, dd.cbp_v):
        c8 = np.zeros((H // 8, W // 8), bool)
        c8[:h8, :w8] = ((cbp > 0) & notbi)[::2, ::2][:h8, :w8]
        out.append(c8)
    return tuple(out)


def clpf_sb_sums(y, org_y, cy8, H, W):
    """The CLPF decision's measure (detect_clpf, enc/encode_block.c:3036):
    per whole superblock, the luma squared error over the candidate 8x8
    cells (cy8: [H/8, W/8] bool on the device) without and with the filter,
    as a [2, SBH, SBW] int64 tensor on the device."""
    SBH, SBW = H // MAX_BLOCK_SIZE, W // MAX_BLOCK_SIZE
    every = torch.ones((H // 8, W // 8), dtype=torch.bool, device=y.device)
    Fy = K.clpf_plane(y, every, MAX_BLOCK_SIZE, H, W)
    m = K._expand2(cy8, 8, 8)

    def sb_sums(E):
        E = torch.where(m, E, 0)[:SBH * 64, :SBW * 64].to(torch.int64)
        return E.view(SBH, 64, SBW, 64).sum(dim=(1, 3))

    return torch.stack([sb_sums((org_y - y) ** 2), sb_sums((org_y - Fy) ** 2)])


def clpf_apply(y, u, v, c8, on8, H, W):
    """The CLPF of the planes on the cells of c8 (the candidate masks
    (cy8, cu8, cv8)) that on8 switches on, all [H/8, W/8] bool on the
    device."""
    return (K.clpf_plane(y, c8[0] & on8, MAX_BLOCK_SIZE, H, W),
            K.clpf_plane(u, c8[1] & on8, MAX_BLOCK_SIZE // 2, H // 2, W // 2),
            K.clpf_plane(v, c8[2] & on8, MAX_BLOCK_SIZE // 2, H // 2, W // 2))


def _replay_filters(rec, y, u, v, org_y):
    """The in-loop filters of a recorded frame on the device: deblocking
    on the recorded side-info map, then the CLPF with its decision taken on
    the device (the live encode fetches the sums to write the bits)."""
    H, W, qp = rec["H"], rec["W"], rec["qpY"]
    if rec["deblocking"]:
        dd = K.unpack_ddp(rec["ddp"])
        tc_c = int(TC_TABLE[CHROMA_QP[qp]])
        y = K.deblock_luma(y, dd, H, W, int(BETA_TABLE[qp]),
                           int(TC_TABLE[qp]))
        u = K.deblock_chroma(u, dd, H, W, tc_c)
        v = K.deblock_chroma(v, dd, H, W, tc_c)
    c8 = rec["clpf_cand"]
    if c8 is not None:
        SBH, SBW = H // MAX_BLOCK_SIZE, W // MAX_BLOCK_SIZE
        sums = clpf_sb_sums(y, org_y, c8[0], H, W)
        cand = (c8[0] | c8[1] | c8[2])[:SBH * 8, :SBW * 8] \
            .view(SBH, 8, SBW, 8).any(dim=3).any(dim=1)
        on_sb = cand & (sums[1] < sums[0])
        on8 = torch.zeros_like(c8[0])
        on8[:SBH * 8, :SBW * 8] = on_sb.repeat_interleave(8, 0) \
            .repeat_interleave(8, 1)
        y, u, v = clpf_apply(y, u, v, c8, on8, H, W)
    return y, u, v


def replay_device_frame(rec, refstate):
    """Run one recorded P/B frame's device work again. A frame of the
    fused path replays its programs (enc/fused.replay_frame). Stage by
    stage: ME and the motion
    variants, the trials of every size and of the second chance's
    variants, the intra search, the final reconstruction (kernels 2 and 6)
    and the in-loop filters, against the reference chain in `refstate`
    ({key: padded (Y, U, V)}). The recorded decisions (the walk's leaves
    as a final_plan, the side-info map, the CLPF candidates) stand in for
    the host walk and the emit. Inserts the frame's padded reference
    planes into refstate and returns its (y, u, v) uint8 reconstruction.

    Adds no host wait of its own (no fetch of a device tensor; the
    quantizer's zero-run pass runs on the card, csrc/rdoq.cu). Every
    tensor it reads lies on the record, staged there when it was
    recorded."""
    if rec["fused"] is not None:
        return FU.replay_frame(rec, refstate)
    for key, planes in rec["uploads"].items():
        refstate.setdefault(key, planes)
    refs = tuple(torch.stack([refstate[k][c] for k in rec["ref_keys"]])
                 for c in range(3))
    org, p = rec["org"], rec["params"]
    H, W = rec["H"], rec["W"]
    ctx = dict(org=org, refs=refs, qpY=rec["qpY"], qpC=rec["qpC"],
               sign=rec["sign"], sign_bi=rec["sign_bi"],
               luts_np=rec["luts_np"], K_uni=rec["K_uni"])
    _, ctx["trials"] = _measure(
        org, refs, rec["R"], rec["K_uni"], rec["has_bi"], rec["bslot0"],
        rec["bslot1"], rec["sign"], rec["sign_bi"], rec["lam_me"],
        rec["qpY"], rec["qpC"], p, rec["luts_np"])
    for s, ev in rec["extra"].items():
        splice_extra(ctx, ev, s, p)
    search_intra_frame_dev(*org, rec["qpY"], rec["qpC"], rec["lam"], W, H,
                           p.encoder_speed > 1, rec["nmodes"],
                           intra_quant=False)
    y, u, v, _, _ = final_frame(
        refs, org, ctx["trials"], rec["plan"], rec["qpY"], rec["qpC"],
        mc_luts(int(p.enable_bipred), org[0].device), p.encoder_speed > 1,
        H, W)
    y, u, v = (t.to(torch.uint8)
               for t in _replay_filters(rec, y, u, v, org[0]))
    refstate[("r", rec["frame_num"])] = (K.edge_pad(y, PAD_Y),
                                        K.edge_pad(u, PAD_C),
                                        K.edge_pad(v, PAD_C))
    return y, u, v
