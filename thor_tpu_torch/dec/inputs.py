"""Per-frame input builder: native parse SoA -> the frame program's inputs.

Host numpy, vectorized (thor_tpu dec/native_inputs.py:366-628,
build_frame_inputs_meta and _clpf_masks_native). It depends only on the
parsed frame and the display numbers of the reference window, so it runs
in a worker thread ahead of the frame program. Records come out in the
port's own layouts (ops/mc.py, ops/intra.py); nothing is padded to
bucket sizes, since PyTorch compiles nothing per shape.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..codec.constants import (
    BETA_TABLE, CHROMA_QP, GDEQUANT_TABLE, PAD_C, PAD_Y, TC_TABLE)
from ..ops.intra import build_intra_records
from ..ops.kernels import pack_ddp
from ..ops.mc import build_mc_pus, build_mc_records


class FrameConfig(NamedTuple):
    W: int
    H: int
    R: int                  # reference slots used (0 = intra frame)
    deblocking: bool
    clpf: bool


def _upright_available_v(ypos, xpos, size, width):
    avail = (ypos > 0) & (xpos + size < width)
    avail &= ~((size == 32) & (ypos % 64 == 32))
    avail &= ~((size == 16) & ((ypos % 32 == 16)
               | ((ypos % 64 == 32) & (xpos % 32 == 16))))
    avail &= ~((size == 8) & ((ypos % 16 == 8)
               | ((ypos % 32 == 16) & (xpos % 16 == 8))
               | ((ypos % 64 == 32) & (xpos % 32 == 24))))
    return avail


def _downleft_available_v(ypos, xpos, size, height):
    avail = (xpos > 0) & (ypos + size < height)
    avail &= size != 64
    avail &= ~((size == 32) & (ypos % 64 == 32))
    avail &= ~((size == 16) & ((ypos % 64 == 48)
               | ((ypos % 64 == 16) & (xpos % 32 == 16))))
    avail &= ~((size == 8) & ((ypos % 64 == 56)
               | ((ypos % 16 == 8) & (xpos % 16 == 8))
               | ((ypos % 64 == 24) & (xpos % 32 == 16))))
    return avail


def _dq_arrays(qp, tsize_log2):
    """Dequant factor / rounding add / shift per TU
    (common/common_block.c:132-146)."""
    factor = GDEQUANT_TABLE[qp % 6].astype(np.int32) << (qp // 6)
    rshift = tsize_log2 - 1
    add = (1 << (rshift - 1)).astype(np.int32)
    return factor, add, rshift.astype(np.int32)


def _emit_sparse_tus(acc, coeff_buf, offs, sizes, ys, xs, qps, tb, nz_ok,
                     plane_id=None):
    """Nonzero coefficients straight from the parser's per-block slab
    buffer, grouped by final transform size.

    acc: dict final-group-size -> accumulator (see _pack_sparse). Layout
    contract with thor_entropy.c: every block reserves a size*size raster
    slab at offs[i] (quadrants of a tb-split block occupy the spatial
    quadrants of the slab; a non-split 64-block codes only its top-left
    32x32)."""
    sel = np.nonzero(nz_ok)[0]
    if not len(sel):
        return
    co = offs[sel]
    bs = sizes[sel].astype(np.int64)
    end = int(co[-1] + bs[-1] * bs[-1])
    nz = np.flatnonzero(coeff_buf[:end])
    if not len(nz):
        return
    j = np.searchsorted(co, nz, side='right') - 1
    o = nz - co[j]
    s = bs[j]
    r = (o // s).astype(np.int64)
    c = (o % s).astype(np.int64)
    v = coeff_buf[nz].astype(np.int32)
    is_tb = tb[sel][j]
    s2 = s >> 1
    subk = np.where(is_tb, (r >= s2) * 2 + (c >= s2), 0)
    rl = np.where(is_tb, r % s2, r)
    cl = np.where(is_tb, c % s2, c)
    # tb quadrants land in the s/2 group; non-split 64-blocks keep their
    # own group (32x32 bank, tr_log2 6)
    gkey = np.where(is_tb, s2, s)
    keep = (rl < 32) & (cl < 32)
    for g in np.unique(gkey):
        m = keep & (gkey == g)
        if not m.any():
            continue
        key = j[m] * 4 + subk[m]
        uk, inv = np.unique(key, return_inverse=True)
        ju = uk >> 2
        ku = uk & 3
        su = bs[ju]
        s2u = su >> 1
        tbu = tb[sel][ju]
        gy = ys[sel][ju] + np.where(tbu, (ku >> 1) * s2u, 0)
        gx = xs[sel][ju] + np.where(tbu, (ku & 1) * s2u, 0)
        tl = np.where(tbu, np.log2(s2u),
                      np.where(su == 64, 6, np.log2(su))).astype(np.int32)
        a = acc.setdefault(int(g), {
            'n': 0, 'ys': [], 'xs': [], 'qp': [], 'tl': [], 'pl': [],
            'sl': [], 'rl': [], 'cl': [], 'vv': []})
        a['ys'].append(gy.astype(np.int32))
        a['xs'].append(gx.astype(np.int32))
        a['qp'].append(qps[sel][ju].astype(np.int32))
        a['tl'].append(tl)
        if plane_id is not None:
            a['pl'].append(np.full(len(uk), plane_id, np.int32))
        a['sl'].append(inv.reshape(-1).astype(np.int64) + a['n'])
        a['rl'].append(rl[m])
        a['cl'].append(cl[m])
        a['vv'].append(v[m])
        a['n'] += len(uk)


def _pack_sparse(a, g, with_pl):
    """Accumulator -> {cidx, cval, y, x, f, a, sh[, pl]} for one size
    group (the device densifies cidx/cval into an [n, cs, cs] bank)."""
    cs = 32 if g == 64 else g
    sl = np.concatenate(a['sl'])
    lin = sl * cs * cs + np.concatenate(a['rl']) * cs \
        + np.concatenate(a['cl'])
    qp = np.concatenate(a['qp'])
    fac, add, rsh = _dq_arrays(qp, np.concatenate(a['tl']))
    out = {'cidx': lin.astype(np.int64),
           'cval': np.concatenate(a['vv']).astype(np.int32),
           'y': np.concatenate(a['ys']), 'x': np.concatenate(a['xs']),
           'f': fac, 'a': add, 'sh': rsh}
    if with_pl:
        out['pl'] = np.concatenate(a['pl'])
    return out


def _intra_tus(nf, W, H):
    """Decode-order luma and chroma intra TU dicts (tb-split blocks give
    four quadrant TUs with their own availability), or (None, None)."""
    ii = np.nonzero(nf.mode == 1)[0]
    if not len(ii):
        return None, None
    bsz = nf.size[ii]
    by, bx = nf.ypos[ii], nf.xpos[ii]
    imod = nf.intra_mode[ii]
    btb = nf.tb_split[ii].astype(bool)
    up = _upright_available_v(by, bx, bsz, W)
    dl = _downleft_available_v(by, bx, bsz, H)

    def mk(by, bx, bsz, btb, cbx_base):
        counts = np.where(btb, 4, 1)
        offs = np.concatenate([[0], np.cumsum(counts)])[:-1]
        n = int(counts.sum())
        t = {k: np.zeros(n, np.int32) for k in
             ("ty", "tx", "size", "mode", "toplen", "leftlen",
              "cbx_nonzero")}
        ntb = ~btb
        o = offs[ntb]
        t["ty"][o] = by[ntb]
        t["tx"][o] = bx[ntb]
        t["size"][o] = bsz[ntb]
        t["mode"][o] = imod[ntb]
        t["toplen"][o] = bsz[ntb] + up[ntb]
        t["leftlen"][o] = bsz[ntb] + dl[ntb]
        t["cbx_nonzero"][o] = cbx_base[ntb] > 0
        if btb.any():
            o = offs[btb]
            s2 = bsz[btb] // 2
            for k, (qi, qj) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
                p = o + k
                t["ty"][p] = by[btb] + qi * s2
                t["tx"][p] = bx[btb] + qj * s2
                t["size"][p] = s2
                t["mode"][p] = imod[btb]
                t["toplen"][p] = s2 + ((qj == 0) | ((qi == 0) & up[btb]))
                t["leftlen"][p] = s2 + ((qj == 0) & ((qi == 0) | dl[btb]))
                t["cbx_nonzero"][p] = cbx_base[btb] > 0
        return t

    tuy = mk(by, bx, bsz, btb, bx)
    tuc = mk(by // 2, bx // 2, bsz // 2, btb & (bsz > 8), bx // 2)
    return tuy, tuc


def clpf_masks(nf, W, H):
    """Per-8x8-cell CLPF application masks from the side-info map
    (common/common_frame.c:485-557)."""
    fh = nf.hdr
    dd = nf.dd
    h8, w8 = H // 8, W // 8
    m8 = np.zeros((3, h8, w8), bool)
    if not fh.clpf_frame_enable:
        return m8[0], m8[1], m8[2]
    notbi = dd["mode"][::2, ::2] != 3          # [h8, w8] at 8-px cells
    cy = dd["cbp_y"][::2, ::2] > 0
    cu = dd["cbp_u"][::2, ::2] > 0
    cv = dd["cbp_v"][::2, ::2] > 0
    anyc = notbi & (cy | cu | cv)
    nsb_v, nsb_h = H // 64, W // 64
    full8v, full8h = nsb_v * 8, nsb_h * 8
    cand = anyc[:full8v, :full8h].reshape(nsb_v, 8, nsb_h, 8) \
        .any(axis=(1, 3))
    if fh.clpf_all:
        on = cand
    else:
        on = cand & (nf.clpf_bits[:nsb_v * nsb_h].reshape(nsb_v, nsb_h)
                     == 1)
    on8 = np.zeros((h8, w8), bool)
    on8[:full8v, :full8h] = np.repeat(np.repeat(on, 8, 0), 8, 1)
    return on8 & notbi & cy, on8 & notbi & cu, on8 & notbi & cv


def build_frame_inputs(nf, seq, ref_frame_nums):
    """NativeFrame -> (FrameConfig, inputs, slots).

    inputs is a dict of numpy arrays (nested dicts for residual groups
    "gy{s}" / "gc{s}"); slots lists the ref_array entries whose planes
    the frame program stacks, in slot order (-1: the interpolated
    reference, whose display number is the frame's own)."""
    W, H = seq.width, seq.height
    fh = nf.hdr
    dd = nf.dd
    inp = {}

    R = fh.num_ref
    slots = [fh.ref_array[i] for i in range(R)]
    if R > 0:
        fnum = np.array([ref_frame_nums[r] if r >= 0
                         else fh.display_frame_num for r in slots], np.int64)
        pus = build_mc_pus(nf, R, fnum, fh.display_frame_num, W, H)
        inp["mc_y"], ny = build_mc_records(pus, H, W, PAD_Y, 2, -2, 6)
        pus_c = dict(pus)
        for k in ("y0", "x0", "h", "w"):
            pus_c[k] = pus[k] // 2
        inp["mc_c"], nc = build_mc_records(pus_c, H // 2, W // 2, PAD_C,
                                           3, -1, 4)
        inp["mc_clamped"] = ny + nc

    # --- residual TU groups, sparse ---
    sizes, ys, xs, qps = nf.size, nf.ypos, nf.xpos, nf.qp
    qpc = CHROMA_QP[qps].astype(np.int32)
    tb = nf.tb_split.astype(bool)
    tbc = tb & (sizes > 8)
    cbp = nf.cbp
    acc_y, acc_c = {}, {}
    _emit_sparse_tus(acc_y, nf.coeff_y, nf.coff_y, sizes, ys, xs, qps, tb,
                     (cbp & 1) != 0)
    _emit_sparse_tus(acc_c, nf.coeff_u, nf.coff_u, sizes // 2, ys // 2,
                     xs // 2, qpc, tbc, (cbp & 2) != 0, plane_id=0)
    _emit_sparse_tus(acc_c, nf.coeff_v, nf.coff_v, sizes // 2, ys // 2,
                     xs // 2, qpc, tbc, (cbp & 4) != 0, plane_id=1)
    for s, a in acc_y.items():
        inp[f"gy{s}"] = _pack_sparse(a, s, False)
    for s, a in acc_c.items():
        inp[f"gc{s}"] = _pack_sparse(a, s, True)

    # --- intra TU records in decode order ---
    tuy, tuc = _intra_tus(nf, W, H)
    if tuy is not None:
        inp["it_y"] = build_intra_records(tuy, H, W)
        inp["it_c"] = build_intra_records(tuc, H // 2, W // 2)

    if seq.deblocking:
        inp["ddp"] = pack_ddp({k: dd[k] for k in (
            "size", "tb_split", "pb_part", "mode", "cbp_y", "mv0x", "mv0y",
            "mv1x", "mv1y")})
        inp["beta"] = int(BETA_TABLE[fh.qp])
        inp["tc"] = int(TC_TABLE[fh.qp])
        inp["tcC"] = int(TC_TABLE[CHROMA_QP[fh.qp]])
    if seq.clpf:
        inp["m8y"], inp["m8u"], inp["m8v"] = clpf_masks(nf, W, H)

    cfg = FrameConfig(W=W, H=H, R=R, deblocking=bool(seq.deblocking),
                      clpf=bool(seq.clpf))
    return cfg, inp, slots
