"""Block motion compensation: the CUDA kernel's wrapper (csrc/mc.cu), its
plain PyTorch version, and the host builders of its PU records.

Counterpart of thor_tpu/ops/pallas_mc.py (kernel 1 of the port). The
record layout is the port's own, one row per PU piece:

    y0, x0, h, w, slot0, phase0, iy0, ix0, bi, slot1, phase1, iy1, ix1

(y0, x0, h, w) is the output rectangle in plane pixels; per list, `slot`
indexes the reference stack, `phase` the LUT row, and (iy, ix) is the
top-left tap of the window in the codec-padded reference. PUs larger than
TILE x TILE are split into TILE x TILE pieces (one warp of the kernel
each).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import check_current
from . import _build

NF = 13
(R_Y0, R_X0, R_H, R_W, R_S0, R_P0, R_IY0, R_IX0, R_BI, R_S1, R_P1,
 R_IY1, R_IX1) = range(NF)
TILE = {6: 16, 4: 8}      # piece size per tap count (luma, chroma)
CELL = {6: 4, 4: 2}       # MV cell side per tap count (luma, chroma)

I32 = torch.int32


# ---------------------------------------------------------------------------
# Host-side PU and record builders
# ---------------------------------------------------------------------------

def build_mc_pus(nf, R, fnum, cur, W, H):
    """Per-prediction-unit MC params from the native block records
    (thor_tpu dec/native_inputs.py:259 build_mc_pus_native).

    Expands each coded block into its prediction units (PB partitions,
    enc/encode_block.c PART_*), clips border blocks to the frame, and
    sign-folds MVs: a reference displayed after the current frame
    (or at it, for list 1 and bipred list 0) has its MV negated. Intra
    blocks emit a zero-MV slot-0 PU so the records tile the frame; the
    intra scan overwrites those pixels. Returns a dict of luma-coordinate
    int64 arrays {y0, x0, h, w, slot0, mvx0, mvy0, bi, slot1, mvx1, mvy1}.
    """
    y0, x0, size = nf.ypos, nf.xpos, nf.size
    mode = nf.mode
    pbp = nf.dd["pb_part"][y0 // 4, x0 // 4]
    pbp = np.where(mode == 2, pbp, 0)            # only INTER has PBs
    bi = nf.dir == 2
    slot0 = np.clip(nf.ref_idx0, 0, R - 1).astype(np.int64)
    slot1 = np.clip(nf.ref_idx1, 0, R - 1).astype(np.int64)
    intra = mode == 1
    slot0 = np.where(intra, 0, slot0)
    slot1 = np.where(intra, 0, slot1)
    sign0 = np.where(bi, fnum[slot0] >= cur, fnum[slot0] > cur)
    sign1 = fnum[slot1] >= cur

    out = {k: [] for k in ("y0", "x0", "h", "w", "slot0", "mvx0",
                           "mvy0", "bi", "slot1", "mvx1", "mvy1")}
    # pb_part -> (MV quadrant per PU, PU (row, col, h, w) in half sizes)
    quads = {0: ((0,), [(0, 0, 2, 2)]),
             1: ((0, 2), [(0, 0, 1, 2), (1, 0, 1, 2)]),
             2: ((0, 1), [(0, 0, 2, 1), (0, 1, 2, 1)]),
             3: ((0, 1, 2, 3), [(0, 0, 1, 1), (0, 1, 1, 1),
                                (1, 0, 1, 1), (1, 1, 1, 1)])}
    for part, (ks, geoms) in quads.items():
        sel = np.nonzero(pbp == part)[0]
        if not len(sel):
            continue
        s2 = size[sel] // 2
        for k, (qi, qj, gh, gw) in zip(ks, geoms):
            py = y0[sel] + qi * s2
            px = x0[sel] + qj * s2
            ph = np.minimum(gh * s2, H - py)
            pw = np.minimum(gw * s2, W - px)
            keep = (ph > 0) & (pw > 0)
            if not keep.any():
                continue
            kk = sel[keep]
            mvx0 = np.where(sign0[kk], -nf.mv0x[kk, k], nf.mv0x[kk, k])
            mvy0 = np.where(sign0[kk], -nf.mv0y[kk, k], nf.mv0y[kk, k])
            mvx0 = np.where(intra[kk], 0, mvx0)
            mvy0 = np.where(intra[kk], 0, mvy0)
            mvx1 = np.where(sign1[kk], -nf.mv1x[kk, k], nf.mv1x[kk, k])
            mvy1 = np.where(sign1[kk], -nf.mv1y[kk, k], nf.mv1y[kk, k])
            out["y0"].append(py[keep])
            out["x0"].append(px[keep])
            out["h"].append(ph[keep])
            out["w"].append(pw[keep])
            out["slot0"].append(slot0[kk])
            out["mvx0"].append(mvx0)
            out["mvy0"].append(mvy0)
            out["bi"].append(bi[kk].astype(np.int64))
            out["slot1"].append(slot1[kk])
            out["mvx1"].append(mvx1)
            out["mvy1"].append(mvy1)
    return {k: (np.concatenate(v).astype(np.int64) if v
                else np.zeros(0, np.int64)) for k, v in out.items()}


def build_mc_records(pus, H, W, pad, frac_bits, tap_lo, T):
    """PU dict (plane pixel coordinates, MVs sign-folded, in 1/2^frac_bits
    pel) -> ([N, 13] int32 records, number of clamped cell windows).

    `mv >> frac_bits` and `mv & mask` keep floor semantics for negative
    MVs (numpy's shift is arithmetic). List 1 of a uni-predicted PU
    mirrors list 0, so every window a record names is a real one.

    A PU whose window leaves the (H+2pad) x (W+2pad) plane is clamped the
    way thor_tpu's per-cell gather clamps it (jax_kernels.py:133-134,
    mc_plane): its record is split into MV cells (4x4 luma, 2x2 chroma)
    and each cell's window origin is mapped into the plane on its own as
    lax.dynamic_slice maps a start index: a negative one counts from the
    far edge, then it is clipped so that the window fits. The golden
    streams never need it; the count says how many (cell, list) windows
    were moved.
    """
    y0 = np.asarray(pus["y0"], np.int64)
    x0 = np.asarray(pus["x0"], np.int64)
    h = np.asarray(pus["h"], np.int64)
    w = np.asarray(pus["w"], np.int64)
    Hp, Wp = H + 2 * pad, W + 2 * pad
    fm = (1 << frac_bits) - 1

    def side(sl, mvx, mvy):
        mvx = np.asarray(mvx, np.int64)
        mvy = np.asarray(mvy, np.int64)
        phase = (mvy & fm) * (fm + 1) + (mvx & fm)
        iy = y0 + (mvy >> frac_bits) + pad + tap_lo
        ix = x0 + (mvx >> frac_bits) + pad + tap_lo
        return np.asarray(sl, np.int64), phase, iy, ix

    bi = np.asarray(pus["bi"], np.int64)
    l0 = side(pus["slot0"], pus["mvx0"], pus["mvy0"])
    l1 = side(pus["slot1"], pus["mvx1"], pus["mvy1"])
    l1 = [np.where(bi != 0, b, a) for a, b in zip(l0, l1)]
    rec = np.stack([y0, x0, h, w, *l0, bi, *l1], axis=1)
    leaves = np.zeros(len(rec), bool)
    for fy, fx in ((R_IY0, R_IX0), (R_IY1, R_IX1)):
        leaves |= ((rec[:, fy] < 0) | (rec[:, fx] < 0)
                   | (rec[:, fy] + h + T - 1 > Hp)
                   | (rec[:, fx] + w + T - 1 > Wp))
    if not leaves.any():
        return _split_tiles(rec, TILE[T]).astype(np.int32), 0
    cs = CELL[T]
    cells = _split_tiles(rec[leaves], cs)
    clipped = np.zeros((len(cells), 2), bool)
    ws = cs + T - 1

    def start(i, n):                     # lax.dynamic_slice's start index
        return np.clip(np.where(i < 0, i + n, i), 0, n - ws)

    for k, (fy, fx) in enumerate(((R_IY0, R_IX0), (R_IY1, R_IX1))):
        iy, ix = start(cells[:, fy], Hp), start(cells[:, fx], Wp)
        clipped[:, k] = (iy != cells[:, fy]) | (ix != cells[:, fx])
        cells[:, fy], cells[:, fx] = iy, ix
    clamped = int(clipped[:, 0].sum() + (clipped[:, 1]
                                         & (cells[:, R_BI] != 0)).sum())
    rec = np.concatenate([_split_tiles(rec[~leaves], TILE[T]), cells])
    return rec.astype(np.int32), clamped


def _split_tiles(rec, tile):
    """Split records whose rectangle exceeds tile x tile into pieces."""
    nty = -(-rec[:, R_H] // tile)
    ntx = -(-rec[:, R_W] // tile)
    cnt = nty * ntx
    if (cnt == 1).all():
        return rec
    src = np.repeat(np.arange(len(rec)), cnt)
    k = np.arange(len(src)) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    dy = (k // ntx[src]) * tile
    dx = (k % ntx[src]) * tile
    out = rec[src].copy()
    out[:, R_Y0] += dy
    out[:, R_X0] += dx
    out[:, R_H] = np.minimum(tile, out[:, R_H] - dy)
    out[:, R_W] = np.minimum(tile, out[:, R_W] - dx)
    for f in (R_IY0, R_IY1):
        out[:, f] += dy
    for f in (R_IX0, R_IX1):
        out[:, f] += dx
    return out


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def mc_frame_plain(refs, recs, lut, H: int, W: int):
    """Reference semantics of the kernel, in tensor ops: records are
    grouped by rectangle shape and each group's tap windows gathered at
    once. refs: [C, R, Hp, Wp] uint8; recs: [N, 13] int32; lut:
    [P, T*T] int32. Returns [C, H, W] int32 (0 where no record writes)."""
    mc_frame_plain.calls += 1
    C = refs.shape[0]
    T = int(round(lut.shape[1] ** 0.5))
    dev = refs.device
    out = torch.zeros((C, H, W), dtype=I32, device=dev)
    rh = recs.cpu().numpy()
    recs = recs.long()
    for hh, ww in sorted(set(zip(rh[:, R_H].tolist(), rh[:, R_W].tolist()))):
        sel = np.nonzero((rh[:, R_H] == hh) & (rh[:, R_W] == ww))[0]
        r = recs[torch.from_numpy(sel).to(dev)]
        n = len(sel)
        ar_h = torch.arange(hh + T - 1, device=dev)
        ar_w = torch.arange(ww + T - 1, device=dev)

        def pred(s, p, iy, ix):
            rows = (iy[:, None] + ar_h)[:, :, None]
            cols = (ix[:, None] + ar_w)[:, None, :]
            win = refs[:, s[:, None, None], rows, cols].to(I32)
            wsel = lut[p].view(1, n, T * T, 1, 1)
            acc = torch.full((C, n, hh, ww), 2048, dtype=I32, device=dev)
            for t in range(T * T):
                m, q = divmod(t, T)
                acc += wsel[:, :, t] * win[:, :, m:m + hh, q:q + ww]
            return torch.clamp(acc >> 12, 0, 255)

        pr = pred(r[:, R_S0], r[:, R_P0], r[:, R_IY0], r[:, R_IX0])
        bi = r[:, R_BI] != 0
        if bool(bi.any()):
            p1 = pred(r[:, R_S1], r[:, R_P1], r[:, R_IY1], r[:, R_IX1])
            pr = torch.where(bi.view(1, n, 1, 1), (pr + p1) >> 1, pr)
        yy = (r[:, R_Y0, None] + torch.arange(hh, device=dev))[:, :, None]
        xx = (r[:, R_X0, None] + torch.arange(ww, device=dev))[:, None, :]
        out[:, yy, xx] = pr
    return out


mc_frame_plain.calls = 0


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        L = _build.cuda_library("mc")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        L.thor_mc_frame.restype = ci
        L.thor_mc_frame.argtypes = [vp, ci, ci, ci, ci, vp, ci, vp, ci, vp,
                                    ci, ci, vp]
        L.thor_cuda_error_string.restype = ctypes.c_char_p
        L.thor_cuda_error_string.argtypes = [ci]
        _lib = L
    return _lib


def mc_frame(refs, recs, lut, H: int, W: int):
    """Block MC of C planes that share one record set.

    refs: [C, R, Hp, Wp] uint8 codec-padded references; recs: [N, 13]
    int32 from build_mc_records; lut: [P, T*T] int32 phase weights.
    Returns the [C, H, W] int32 prediction. A CPU tensor takes the plain
    version; a CUDA tensor launches csrc/mc.cu.
    """
    if refs.device.type == "cpu":
        return mc_frame_plain(refs, recs, lut, H, W)
    if refs.device.type != "cuda":
        raise ValueError(f"mc_frame: unsupported device {refs.device}")
    check_current("mc_frame", refs.device)
    C, R, Hp, Wp = refs.shape
    T = int(round(lut.shape[1] ** 0.5))
    if T not in TILE or lut.shape[1] != T * T:
        raise ValueError(f"mc_frame: bad LUT shape {tuple(lut.shape)}")
    for name, t, dt in (("refs", refs, torch.uint8), ("recs", recs, I32),
                        ("lut", lut, I32)):
        if t.device != refs.device or t.dtype != dt \
                or not t.is_contiguous():
            raise ValueError(f"mc_frame: {name} must be a contiguous "
                             f"{dt} tensor on {refs.device}")
    if recs.dim() != 2 or recs.shape[1] != NF:
        raise ValueError(f"mc_frame: recs must be [N, {NF}]")
    out = torch.zeros((C, H, W), dtype=I32, device=refs.device)
    n = recs.shape[0]
    if n:
        L = _kernel()
        err = L.thor_mc_frame(
            refs.data_ptr(), C, R, Hp, Wp, recs.data_ptr(), n,
            lut.data_ptr(), T, out.data_ptr(), H, W,
            torch.cuda.current_stream(refs.device).cuda_stream)
        if err:
            raise RuntimeError("mc_frame launch failed: "
                               + L.thor_cuda_error_string(err).decode())
        mc_frame.launches += 1
    return out


mc_frame.launches = 0
