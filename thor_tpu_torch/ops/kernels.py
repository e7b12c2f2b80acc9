"""Plain PyTorch ops of the decoder's frame program and of the encoder.

The batched ops of thor_tpu/ops/jax_kernels.py, on int32 tensors. The
JAX package runs these as XLA ops (no Pallas kernel), so plain tensor
ops are their port: residual (dequant + inverse DCT + scatter),
deblocking, CLPF and the MC phase-weight tables for the decoder; forward
transform, forward quantizer and the exact reconstruction from levels for
the encoder. Every op is exact integer arithmetic; `>>` on int32 tensors
is an arithmetic shift, as in JAX and the C reference.

One exception: the quantizer's zero-run pass is serial within a row and
data-dependent. Its plain version (_rdoq_light) asks the host after every
step whether a row has a step left, which on a card is a wait per step
and cannot sit in a CUDA graph; rdoq_light launches the hand-written
kernel csrc/rdoq.cu for a CUDA tensor instead.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..codec.constants import (
    FILTER_C, FILTER_Y_BI, FILTER_Y_CENTER, FILTER_Y_UNI, GDEQUANT_TABLE,
    GQUANT_TABLE, log2i)
from ..codec.dct_tables import TMAT_4, TMAT_8, TMAT_16, TMAT_32
from ..device import check_current
from . import _build

TMAT = {4: np.array(TMAT_4, np.float64), 8: np.array(TMAT_8, np.float64),
        16: np.array(TMAT_16, np.float64),
        32: np.array(TMAT_32, np.float64)}

I32 = torch.int32


def clip255(x):
    return torch.clamp(x, 0, 255)


_TABLES: dict = {}


def device_table(key, device, make):
    """One copy per device of a constant table, made by make() (a numpy
    array) at its first use on that device. A table copied from pageable
    host memory on every call makes the host wait for the stream's queued
    work, and cannot be captured in a CUDA graph (dec/fused.py)."""
    device = torch.device(device)
    t = _TABLES.get((key, device))
    if t is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"constant table {key} first used inside a "
                               "CUDA graph capture; warm up first")
        t = torch.from_numpy(np.ascontiguousarray(make())).to(device)
        _TABLES[(key, device)] = t
    return t


def tmat(size: int, device):
    """The float64 DCT matrix of `size` on `device`."""
    return device_table(("tmat", size), device, lambda: TMAT[size])


def const(a, device):
    """The numpy array `a` as a constant table on `device` (device_table
    keyed by its dtype, shape and bytes): for the small per-geometry
    tables (availability flags, tap LUTs, code lengths) the ops read."""
    a = np.ascontiguousarray(a)
    return device_table(("const", a.dtype.str, a.shape, a.tobytes()),
                        device, lambda: a)


# ---------------------------------------------------------------------------
# Bucketed record sets (dec/fused.py pads a frame's records to a bucket)
# ---------------------------------------------------------------------------

def real_records(recs, count):
    """The head of `recs` that `count` (None, or a [1] int32 tensor: the
    number of real records of a bucket) names; the plain versions' form of
    the kernels' device-side count."""
    return recs if count is None else recs[:int(count.reshape(-1)[0])]


def check_count(fn, count, dev):
    """The device-side count a kernel wrapper takes: None, or one int32 on
    `dev`."""
    if count is not None and (count.device != dev or count.dtype != I32
                              or count.numel() != 1):
        raise ValueError(f"{fn}: count must be one int32 on {dev}")


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
    M = tmat(size, coeff.device)
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


def _deblock_luma_dir(rec, dd, H, W, beta, tc, axis):
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


def deblock_luma(rec, dd, H: int, W: int, beta, tc):
    """Exact two-pass luma deblock (vertical edges, then horizontal).
    beta, tc: ints, or 0-d int32 tensors on the plane's device."""
    rec = _deblock_luma_dir(rec, dd, H, W, beta, tc, 1)
    return _deblock_luma_dir(rec, dd, H, W, beta, tc, 0)


def _deblock_chroma_dir(recC, dd, H, W, tc, axis):
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


def deblock_chroma(recC, dd, H: int, W: int, tc):
    """Chroma deblock. H/W are LUMA dims; recC is [H/2, W/2]; tc as
    deblock_luma's."""
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


# ---------------------------------------------------------------------------
# Encoder side (jax_kernels.py:1008-1142, device_intra.py:93)
# ---------------------------------------------------------------------------

def _wrap16(x):
    """int32 -> int16 value range with wraparound (a C int16_t store)."""
    return ((x + 32768) & 65535) - 32768


def fwd_transform_batch(resid, size: int, fast: bool = False):
    """[N, size, size] int residual -> [N, size, size] int32 coefficients
    of int16 range (only the low min(size, 16)^2 nonzero), mirroring
    common/transform.c:249-330: two matrix stages, each wrapped (not
    saturated) to int16. Sizes above 16 with `fast`, and size 64 always,
    first box-sum the residual down to 16 / 32. The products run in
    float64, exact for the same reason as in idct_batch."""
    n_in = resid.shape[0]
    dsize = size
    qsize = min(size, 16)
    shift_1 = log2i(size)
    shift_2 = shift_1 + 5
    inb = resid.to(I32)
    if size > 16 and fast:
        shift_1 += 1 + (1 if size == 64 else 0)
        shift_2 = 9
        f = size // 16
        inb = inb.reshape(-1, 16, f, 16, f).sum(dim=(2, 4))
        size = 16
    elif size == 64:
        shift_1, shift_2 = 7, 10
        inb = inb.reshape(-1, 32, 2, 32, 2).sum(dim=(2, 4))
        size = 32
    M = tmat(size, resid.device)[:qsize]
    add_1, add_2 = 1 << (shift_1 - 1), 1 << (shift_2 - 1)
    # tmp[n,i,j] = sum_k M[i,k] in[n,j,k];
    # coeff[n,i,j] = sum_k M[i,k] tmp[n,j,k]
    tmp = torch.matmul(M, inb.to(torch.float64).transpose(1, 2)).to(I32)
    tmp = _wrap16((tmp + add_1) >> shift_1)
    coeff = torch.matmul(M, tmp.to(torch.float64).transpose(1, 2)).to(I32)
    coeff = _wrap16((coeff + add_2) >> shift_2)
    out = torch.zeros((n_in, dsize, dsize), dtype=I32, device=resid.device)
    out[:, :qsize, :qsize] = coeff
    return out


def quantize_fwd_batch(coeff, qp: int, size: int, intra: bool, zigzag_inv,
                       chroma: bool = False):
    """Forward quantizer (enc/encode_block.c:75-172): zigzag scan,
    last-position search with the 38 / -26 offsets, forward quantization
    with the 102/51 and 115/90 offsets (chroma always takes the low one),
    then the unconditional zero-run pass.

    coeff: [N, size, size] int; zigzag_inv: [qsize^2] (array or tensor) with
    scoeff[zz[i*q+j]] = coeff[i, j]. Returns ([N, size, size] int32
    levels, [N] bool cbp). cbp is taken before the zero-run pass and
    masks its result; the pass only ever writes +-1, so cbp equals
    "any level nonzero" afterwards too."""
    q, scoeff, last_pos, zz = quant_scan(coeff, qp, size, intra, zigzag_inv,
                                         chroma)
    qsize = min(size, 16)
    Nc = qsize * qsize
    cbp = (q != 0).any(dim=1)
    q = rdoq_light(q, scoeff, last_pos, qp, log2i(size), Nc, chroma)
    q = torch.where(cbp[:, None], q, 0)
    out = torch.zeros((coeff.shape[0], size, size), dtype=I32,
                      device=coeff.device)
    out[:, :qsize, :qsize] = q[:, zz].reshape(-1, qsize, qsize)
    return out, cbp


def quant_scan(coeff, qp: int, size: int, intra: bool, zigzag_inv,
               chroma: bool = False):
    """quantize_fwd_batch up to its zero-run pass: (q [N, Nc] int32
    scan-order levels, zero past each row's last position; scoeff [N, Nc]
    int32 raw coefficients in scan order; last_pos [N] int32, -1 for a
    block with no significant coefficient; zz, the zigzag on the device),
    Nc = min(size, 16)^2: the inputs of rdoq_light."""
    qsize = min(size, 16)
    Nc = qsize * qsize
    tr_log2size = log2i(size)
    dev = coeff.device
    scale = int(GQUANT_TABLE[qp % 6])
    shift2 = 21 - tr_log2size + qp // 6

    block = coeff[:, :qsize, :qsize].reshape(-1, Nc).to(I32)
    if torch.is_tensor(zigzag_inv):
        zz = zigzag_inv.to(dev, torch.long)
    else:
        zz = np.asarray(zigzag_inv, np.int64)
        zz = device_table(("zigzag", zz.tobytes()), dev, lambda: zz)
    scoeff = torch.zeros_like(block)
    scoeff[:, zz] = block

    off_last = (38 if intra else -26) << (shift2 - 8)
    off0 = (102 if intra else 51) << (shift2 - 8)
    off1 = (115 if intra else 90) << (shift2 - 8)
    absc = scale * scoeff.abs()
    pos = _arange(Nc, dev)[None, :]
    nz = ((absc + off_last).abs() >> shift2) != 0
    last_pos = torch.where(nz, pos, -1).amax(dim=1)           # [N]

    sign = (scoeff >> 31) | 1                 # -1 below zero, else 1
    if chroma:
        level = (absc + off0) >> shift2
    else:
        level = (absc + torch.where((absc >> shift2) == 0, off0, off1)) \
            >> shift2
    q = torch.where(pos <= last_pos[:, None], sign * level, 0)
    return q, scoeff, last_pos, zz


def _rdoq_threshold(qp: int, tr_log2size: int) -> int:
    return (73 * int(GDEQUANT_TABLE[qp % 6]) << (qp // 6)) \
        >> (4 + tr_log2size)


_rdoq_lib = None


def _rdoq_kernel():
    global _rdoq_lib
    if _rdoq_lib is None:
        L = _build.cuda_library("rdoq")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        L.thor_rdoq.restype = ci
        L.thor_rdoq.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, vp]
        L.thor_cuda_error_string.restype = ctypes.c_char_p
        L.thor_cuda_error_string.argtypes = [ci]
        _rdoq_lib = L
    return _rdoq_lib


def rdoq_light(q, scoeff, last_pos, qp: int, tr_log2size: int, Nc: int,
               chroma: bool):
    """The zero-run pass of [N, Nc] scan-order levels q (zero past each
    row's last_pos), raw coefficients scoeff and [N] last_pos: a new
    [N, Nc] int32 tensor. A CPU tensor takes the plain version
    (_rdoq_light); a CUDA tensor launches csrc/rdoq.cu, one warp a row,
    with no wait for the host; it writes the new tensor whole and reads q
    only up to each row's last_pos."""
    if q.device.type == "cpu":
        return _rdoq_light(q, scoeff, last_pos, qp, tr_log2size, Nc, chroma)
    if q.device.type != "cuda":
        raise ValueError(f"rdoq_light: unsupported device {q.device}")
    check_current("rdoq_light", q.device)
    if Nc > 256 or q.dim() != 2 or q.shape[1] != Nc \
            or scoeff.shape != q.shape or last_pos.shape != q.shape[:1]:
        raise ValueError("rdoq_light: q and scoeff must be [N, Nc <= 256], "
                         "last_pos [N]")
    q = q.to(I32).contiguous()
    out = torch.empty_like(q)
    N = out.shape[0]
    if N and Nc:
        sco = scoeff.to(I32).contiguous()
        last = last_pos.to(I32).contiguous()
        L = _rdoq_kernel()
        err = L.thor_rdoq(q.data_ptr(), out.data_ptr(), sco.data_ptr(),
                          last.data_ptr(), N, Nc,
                          _rdoq_threshold(qp, tr_log2size), int(bool(chroma)),
                          torch.cuda.current_stream(q.device).cuda_stream)
        if err:
            raise RuntimeError("rdoq_light launch failed: "
                               + L.thor_cuda_error_string(err).decode())
        rdoq_light.launches += 1
    return out


rdoq_light.launches = 0


def _rdoq_light(q, scoeff, last_pos, qp: int, tr_log2size: int, Nc: int,
                chroma: bool):
    """The reference's unconditional zero-run adjustment
    (enc/encode_block.c:134-168) on [N, Nc] scan-order levels.

    The reference walks the positions 2..nn-1 in order. Position p
    triggers when its level is above 1 after two zero levels (and the
    levels 3 and 4 back allow it); then the smallest of the three raw
    coefficients decides which of p, p-1, p-2 becomes +-1 (the sign of the
    coefficient there). A step changes only positions p-2..p and a
    trigger reads only positions p-4..p, so the walk is the same as
    jumping from trigger to trigger: find each row's first trigger at or
    after its cursor under the current levels, apply it, move the cursor
    behind it, until no row has one. thor_tpu's XLA form steps through
    every position (jax_kernels._rdoq_light); its TPU kernel jumps as
    this does. The comparisons use the raw |coefficient|, not the scaled
    magnitude. The plain version of rdoq_light (csrc/rdoq.cu)."""
    if Nc <= 2:
        return q
    _rdoq_light.calls += 1
    dev = q.device
    thr = _rdoq_threshold(qp, tr_log2size)
    pos = _arange(Nc, dev)[None, :]
    absv = scoeff.abs()
    sgn = (scoeff >> 31) | 1
    if chroma:
        lp = last_pos[:, None]
        allowed = (pos > 2) & (pos <= lp) | (pos == 2) & (lp >= 2) & (lp < 6)
    else:
        allowed = (pos > 2).expand_as(q)
    q = q.clone()
    cursor = torch.full((q.shape[0], 1), 2, dtype=I32, device=dev)
    while True:
        a = q.abs()
        ap = torch.nn.functional.pad(a, (4, 0))   # zero levels before 0
        am1, am2, am3, am4 = (ap[:, 4 - k:4 - k + Nc] for k in (1, 2, 3, 4))
        act = (allowed & (pos >= cursor) & (a > 1) & (am1 == 0) & (am2 == 0)
               & ~(am3 > 1) & ~((am4 > 1) & (am3 > 0)))
        p = torch.where(act, pos, Nc).amin(dim=1, keepdim=True)
        exists = p < Nc
        if not bool(exists.any()):
            return q
        pc = torch.clamp(p, max=Nc - 1).long()
        c0 = absv.gather(1, pc)
        c1 = absv.gather(1, pc - 1)
        c2 = absv.gather(1, pc - 2)
        tgt = torch.where(c0 + torch.maximum(c1, c2) < thr, pc,
                          torch.where(c1 > c2, pc - 1, pc - 2))
        q.scatter_(1, tgt, torch.where(exists, sgn.gather(1, tgt),
                                       q.gather(1, tgt)))
        cursor = p + 1


_rdoq_light.calls = 0


def recon_from_q(pred, q, s: int, qp: int):
    """Exact dequantization + inverse transform + add + clip, the
    decoder's arithmetic (common/common_block.c:132-156). pred, q:
    [N, s, s]; a 64x64 block inverse-transforms its low 32x32 and repeats
    every sample 2x2."""
    rsh = log2i(s) - 1
    fac = int(GDEQUANT_TABLE[qp % 6]) << (qp // 6)
    rc = torch.clamp((q.to(I32) * fac + (1 << (rsh - 1))) >> rsh,
                     -32768, 32767)
    if s == 64:
        rr = idct_batch(rc[:, :32, :32], 32)
        rr = rr.repeat_interleave(2, 1).repeat_interleave(2, 2)
    else:
        rr = idct_batch(rc, s)
    return clip255(pred + rr)
