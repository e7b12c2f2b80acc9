"""Plain PyTorch ops of the decoder's frame program.

The decode subset of thor_tpu/ops/jax_kernels.py, on int32 tensors. The
JAX package runs these as XLA ops (no Pallas kernel), so plain tensor
ops are their port: residual (dequant + inverse DCT + scatter),
deblocking, CLPF and the MC phase-weight tables. Every op is exact
integer arithmetic; `>>` on int32 tensors is an arithmetic shift, as in
JAX and the C reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codec.constants import (
    FILTER_C, FILTER_Y_BI, FILTER_Y_CENTER, FILTER_Y_UNI)
from ..codec.dct_tables import TMAT_4, TMAT_8, TMAT_16, TMAT_32

TMAT = {4: np.array(TMAT_4, np.float64), 8: np.array(TMAT_8, np.float64),
        16: np.array(TMAT_16, np.float64),
        32: np.array(TMAT_32, np.float64)}

I32 = torch.int32


def clip255(x):
    return torch.clamp(x, 0, 255)


# ---------------------------------------------------------------------------
# Motion compensation weight tables (jax_kernels.py:59, :82)
# ---------------------------------------------------------------------------

def build_luma_mc_lut(seq_bipred: int) -> np.ndarray:
    """[16, 6, 6] int32: combined 2-D weights per (vfrac, hfrac) phase.

    Folds the integer-position copy (weight 4096 at the centre tap), the
    separable 6-tap product (the reference accumulates vertical then
    horizontal with no intermediate rounding, then one (acc+2048)>>12),
    and the (1/2,1/2) 4x4 low-pass whose (s+8)>>4 equals
    (256*s+2048)>>12.
    """
    fset = np.array(FILTER_Y_BI if seq_bipred else FILTER_Y_UNI, np.int64)
    lut = np.zeros((16, 6, 6), np.int64)
    for vf in range(4):
        for hf in range(4):
            p = vf * 4 + hf
            if vf == 0 and hf == 0:
                lut[p, 2, 2] = 4096
            elif vf == 2 and hf == 2:
                lut[p, 1:5, 1:5] = np.array(FILTER_Y_CENTER, np.int64) * 256
            else:
                lut[p] = np.outer(fset[vf], fset[hf])
    return lut.astype(np.int32)


def build_chroma_mc_lut() -> np.ndarray:
    """[64, 4, 4] int32 for the 1/8-pel 4-tap chroma filter."""
    fc = np.array(FILTER_C, np.int64)
    lut = np.zeros((64, 4, 4), np.int64)
    for vf in range(8):
        for hf in range(8):
            p = vf * 8 + hf
            if vf == 0 and hf == 0:
                lut[p, 1, 1] = 4096
            else:
                lut[p] = np.outer(fc[vf], fc[hf])
    return lut.astype(np.int32)


# ---------------------------------------------------------------------------
# Residual: sparse densify, dequant + inverse transform, scatter
# ---------------------------------------------------------------------------

def densify(cidx, cval, n: int, cs: int):
    """Sparse (linear index, value) pairs -> dense [n, cs, cs] int32
    coefficient bank (reconstruct_jax.py:606-617)."""
    flat = torch.zeros(n * cs * cs, dtype=I32, device=cval.device)
    flat.index_add_(0, cidx.long(), cval)
    return flat.view(n, cs, cs)


def idct_batch(coeff, size: int):
    """[N, size, size] int -> [N, size, size] int32 residual.

    The two matrix stages of the reference (common/transform.c:432-486):
    (M^T @ C + 64) >> 7 clamped to int16, then (tmp @ M + 2048) >> 12
    clamped to int16. CUDA has no int32 matmul, so both stages run in
    float64, which is exact here: each stage sums `size` <= 32 products of
    |M| <= 90 and an int16 value, so every partial sum is below
    32 * 90 * 32768 < 2^27, far inside float64's 2^53 integer range.
    float32 or TF32 would not be exact.
    """
    M = torch.as_tensor(TMAT[size], device=coeff.device)
    c = coeff.to(torch.float64)
    tmp = torch.matmul(M.t(), c).to(I32)
    tmp = torch.clamp((tmp + 64) >> 7, -32768, 32767).to(torch.float64)
    out = torch.matmul(tmp, M).to(I32)
    return torch.clamp((out + 2048) >> 12, -32768, 32767)


def residual_group(coeff, dq_factor, dq_add, dq_shift, size: int):
    """Dequantize (common/common_block.c:132-146) + inverse transform.

    coeff: [N, s, s] int; dq_factor/add/shift: [N] int32
    (factor = gdequant_table[qp%6] << (qp/6); shift = log2(tr_size)-1).
    """
    c = coeff.to(I32) * dq_factor[:, None, None]
    c = (c + dq_add[:, None, None]) >> dq_shift[:, None, None]
    c = torch.clamp(c, -32768, 32767)
    return idct_batch(c, size)


def scatter_tu(resid_plane, vals, ys, xs):
    """Add [N, s, s] residuals at per-TU (ys, xs) origins of an [H, W]
    plane. TU origins are s-aligned, so this is a row scatter-add into an
    [ceil(H/s)*ceil(W/s), s*s] bank and a reshape."""
    H, W = resid_plane.shape
    N, s = vals.shape[0], vals.shape[-1]
    HB, WB = -(-H // s), -(-W // s)
    row = (ys // s) * WB + (xs // s)
    bank = torch.zeros((HB * WB, s * s), dtype=vals.dtype,
                       device=vals.device)
    bank.index_add_(0, row.long(), vals.reshape(N, s * s))
    d = bank.view(HB, WB, s, s).permute(0, 2, 1, 3) \
        .reshape(HB * s, WB * s)[:H, :W]
    return resid_plane + d


def scatter_tu_c(rc, vals, ys, xs, pl):
    """Chroma twin of scatter_tu over the [2, Hc, Wc] plane pair; pl
    selects u (0) or v (1)."""
    _, Hc, Wc = rc.shape
    N, s = vals.shape[0], vals.shape[-1]
    HB, WB = -(-Hc // s), -(-Wc // s)
    row = (pl * HB + ys // s) * WB + (xs // s)
    bank = torch.zeros((2 * HB * WB, s * s), dtype=vals.dtype,
                       device=vals.device)
    bank.index_add_(0, row.long(), vals.reshape(N, s * s))
    d = bank.view(2, HB, WB, s, s).permute(0, 1, 3, 2, 4) \
        .reshape(2, HB * s, WB * s)[:, :Hc, :Wc]
    return rc + d


# ---------------------------------------------------------------------------
# Deblocking (common/common_frame.c:46-321)
# ---------------------------------------------------------------------------

def _expand2(a, ry, rx):
    """[h, w] -> [h*ry, w*rx] block expansion."""
    return a.repeat_interleave(ry, 0).repeat_interleave(rx, 1)


def _shifted(a, k, axis):
    """out[i] = a[i + k] along axis (wrapped values are masked off by the
    role/validity masks downstream)."""
    return torch.roll(a, -k, dims=axis)


def pack_ddp(dd) -> np.ndarray:
    """Host side: pack the per-cell side info the deblock reads into one
    uint8 plane: bit0 intra, bit1 cbp_y>0, bit2 any |mv|>=4, bit3
    tb_split, bits4-5 log2(size)-3, bits6-7 pb_part."""
    big = ((np.abs(dd["mv0x"]) >= 4) | (np.abs(dd["mv0y"]) >= 4)
           | (np.abs(dd["mv1x"]) >= 4) | (np.abs(dd["mv1y"]) >= 4))
    size = np.asarray(dd["size"])
    slog = ((size == 16) * 1 + (size == 32) * 2
            + (size == 64) * 3).astype(np.uint8)
    return ((np.asarray(dd["mode"]) == 1).astype(np.uint8)
            | ((np.asarray(dd["cbp_y"]) > 0).astype(np.uint8) << 1)
            | (big.astype(np.uint8) << 2)
            | ((np.asarray(dd["tb_split"]) > 0).astype(np.uint8) << 3)
            | (slog << 4)
            | ((np.asarray(dd["pb_part"]).astype(np.uint8) & 3) << 6))


def unpack_ddp(ddp):
    """pack_ddp's byte plane -> the fields the deblock passes read."""
    d = ddp.to(I32)
    return {
        'mode': d & 1,            # 1 = intra
        'cbp_y': (d >> 1) & 1,
        'bigmv': (d >> 2) & 1,
        'tb_split': (d >> 3) & 1,
        'size': 8 << ((d >> 4) & 3),
        'pb_part': (d >> 6) & 3,
    }


def _arange(n, dev):
    return torch.arange(n, dtype=I32, device=dev)


def _deblock_luma_dir(rec, dd, H, W, beta: int, tc: int, axis):
    """One luma deblock pass (axis=1: vertical edges at columns 8k;
    axis=0: horizontal edges at rows 8k). Edges are 8 apart and the
    filter reaches 2 pixels, so every edge of a pass is independent and
    the pass is one whole-plane shift-select update
    (jax_kernels._deblock_luma_dir)."""
    dev = rec.device
    X = rec
    sm2, sm1, sp1 = (_shifted(X, k, axis) for k in (-2, -1, 1))

    delta = torch.clamp((18 * (X - sm1) - 6 * (sp1 - sm2) + 16) >> 5,
                        -tc, tc)
    dh = torch.sign(delta) * (torch.abs(delta) >> 1)

    ad = torch.abs(sm1 - sm2) + torch.abs(sp1 - X)
    A = ad.view(H // 8, 8, W // 8, 8)
    d8 = (A[:, 2, :, 0] + A[:, 5, :, 0]) if axis == 1 \
        else (A[:, 0, :, 2] + A[:, 0, :, 5])
    act8 = d8 < beta                                   # [H/8, W/8]

    mvq = dd['bigmv'] != 0
    cbpq = dd['cbp_y'] > 0
    intq = dd['mode'] == 1
    mv = mvq | _shifted(mvq, -1, axis)
    cbp = cbpq | _shifted(cbpq, -1, axis)
    intra = intq | _shifted(intq, -1, axis)

    part = dd['pb_part']
    split_part = ((part == 2) | (part == 3)) if axis == 1 \
        else ((part == 1) | (part == 3))
    adj = ((dd['tb_split'] > 0) | split_part) & (dd['size'] > 8)
    qs = torch.where(adj, dd['size'] // 2, dd['size'])
    cells = _arange(W // 4, dev)[None, :] if axis == 1 \
        else _arange(H // 4, dev)[:, None]
    interior = ((4 * cells) % qs) > 0
    cond_cell = ~interior & (mv | cbp | intra)         # [H/4, W/4]

    if axis == 1:
        condE = cond_cell[:, 0::2] & act8.repeat_interleave(2, 0)
        CE = _expand2(condE, 4, 8)
        pos = _arange(W, dev)[None, :]
        n_edge_groups = W // 8
    else:
        condE = cond_cell[0::2, :] & act8.repeat_interleave(2, 1)
        CE = _expand2(condE, 8, 4)
        pos = _arange(H, dev)[:, None]
        n_edge_groups = H // 8
    CEp = _shifted(CE, 8, axis)          # p side: edge of the next group
    c = pos % 8
    grp = pos // 8
    mask_q = CE & (grp >= 1)
    mask_p = CEp & (grp < n_edge_groups - 1)

    out = X
    out = torch.where(mask_q & (c == 0), clip255(X - delta), out)
    out = torch.where(mask_q & (c == 1),
                      clip255(X - _shifted(dh, -1, axis)), out)
    out = torch.where(mask_p & (c == 7),
                      clip255(X + _shifted(delta, 1, axis)), out)
    out = torch.where(mask_p & (c == 6),
                      clip255(X + _shifted(dh, 2, axis)), out)
    return out


def deblock_luma(rec, dd, H: int, W: int, beta: int, tc: int):
    """Exact two-pass luma deblock (vertical edges, then horizontal)."""
    rec = _deblock_luma_dir(rec, dd, H, W, beta, tc, 1)
    return _deblock_luma_dir(rec, dd, H, W, beta, tc, 0)


def _deblock_chroma_dir(recC, dd, H, W, tc: int, axis):
    """One chroma deblock pass (intra edges only, 2-tap delta) on the
    [H/2, W/2] plane; edges follow the luma 8-grid (chroma 4-grid)."""
    dev = recC.device
    Hc, Wc = H // 2, W // 2
    X = recC
    sm2, sm1, sp1 = (_shifted(X, k, axis) for k in (-2, -1, 1))
    delta = torch.clamp((4 * (X - sm1) + (sm2 - sp1) + 4) >> 3, -tc, tc)

    modeq = dd['mode'][0::2, 0::2] == 1
    if axis == 1:
        modep = torch.roll(dd['mode'][0::2, 1::2] == 1, 1, dims=1)
        pos8 = 8 * _arange(W // 8, dev)[None, :]
    else:
        modep = torch.roll(dd['mode'][1::2, 0::2] == 1, 1, dims=0)
        pos8 = 8 * _arange(H // 8, dev)[:, None]
    q_size = dd['size'][0::2, 0::2]
    interior = (pos8 % q_size) > 0
    cond8 = (modeq | modep) & ~interior               # [H/8, W/8]

    CE = _expand2(cond8, Hc // (H // 8), Wc // (W // 8))
    pos = _arange(Wc, dev)[None, :] if axis == 1 \
        else _arange(Hc, dev)[:, None]
    c = pos % 4
    grp = pos // 4
    n_groups = (Wc if axis == 1 else Hc) // 4
    mask_q = CE & (grp >= 1)
    mask_p = _shifted(CE, 4, axis) & (grp < n_groups - 1)

    out = X
    out = torch.where(mask_q & (c == 0), clip255(X - delta), out)
    out = torch.where(mask_p & (c == 3),
                      clip255(X + _shifted(delta, 1, axis)), out)
    return out


def deblock_chroma(recC, dd, H: int, W: int, tc: int):
    """Chroma deblock. H/W are LUMA dims; recC is [H/2, W/2]."""
    recC = _deblock_chroma_dir(recC, dd, H, W, tc, 1)
    return _deblock_chroma_dir(recC, dd, H, W, tc, 0)


# ---------------------------------------------------------------------------
# CLPF (common/common_block.c:180-197, common/common_frame.c:485-557)
# ---------------------------------------------------------------------------

def clpf_plane(plane, mask8, dstride: int, H: int, W: int):
    """+/-1 step toward the 4-neighbour majority, neighbours clamped at
    the dstride-aligned block: block-local, so elementwise.

    plane: [H, W] int32 (pre-CLPF); mask8: [H/bs, W/bs] bool at the
    filter-block granularity (8 luma / 4 chroma pixels).
    """
    dev = plane.device
    iy = _arange(H, dev)[:, None]
    ix = _arange(W, dev)[None, :]
    X = plane
    up = torch.cat([plane[:1], plane[:-1]], 0)
    dn = torch.cat([plane[1:], plane[-1:]], 0)
    lf = torch.cat([plane[:, :1], plane[:, :-1]], 1)
    rt = torch.cat([plane[:, 1:], plane[:, -1:]], 1)
    A = torch.where(iy % dstride == 0, X, up)
    B = torch.where(ix % dstride == 0, X, lf)
    C = torch.where((ix % dstride == dstride - 1) | (ix == W - 1), X, rt)
    D = torch.where((iy % dstride == dstride - 1) | (iy == H - 1), X, dn)
    pos = ((A > X).to(I32) + (B > X) + (C > X) + (D > X)) > 2
    neg = ((A < X).to(I32) + (B < X) + (C < X) + (D < X)) > 2
    delta = pos.to(I32) - neg.to(I32)
    bs = H // mask8.shape[0]
    m = _expand2(mask8, bs, bs)
    return torch.where(m, X + delta, X)


def edge_pad(plane, n: int):
    """Replicate the border n pixels out on every side (the codec's
    reference padding, common/common_frame.c:464-483)."""
    H, W = plane.shape
    dev = plane.device
    ri = torch.clamp(torch.arange(-n, H + n, device=dev), 0, H - 1)
    ci = torch.clamp(torch.arange(-n, W + n, device=dev), 0, W - 1)
    return plane[ri][:, ci]
