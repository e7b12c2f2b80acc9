"""Intra reconstruction scan: the CUDA kernel's wrapper
(csrc/intra_scan.cu), its plain PyTorch version, and the host builder of
its TU records.

Counterpart of thor_tpu/ops/pallas_intra.py (kernel 2 of the port). The
scan is the decoder's one raster dependency: transform units (TUs) are
predicted from already reconstructed neighbours, with the result of a
walk in decode order. The plain version walks that order; the kernel runs
a TU as soon as the earlier TUs that wrote its context samples are done
(`intra_levels` gives the depth of that dependency graph). Records are
the port's own, one row per TU:

    ty, tx, size, mode, toplen, leftlen, cbx_nonzero

toplen / leftlen count the valid context samples (size, or size + 1 when
the up-right / down-left neighbour is available); cbx_nonzero selects
the top-left sample rule (the reference tests the coding block's x).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ..device import check_current
from . import _build
from .kernels import check_count, clip255, real_records

NF = 7
FIELDS = ("ty", "tx", "size", "mode", "toplen", "leftlen", "cbx_nonzero")

# zero padding of the plain version's working planes (jax_kernels.PADI /
# PADE): context reads reach tx + 129, and reads outside the plane see 0
PADI = 8
PADE = 136

SLICE = 512     # pixels of one unit of the kernel's work (csrc/intra_scan.cu)

I32 = torch.int32


def build_intra_records(tus, H, W):
    """Decode-order TU dict (FIELDS -> [N] ints) -> [N, 7] int32 records.
    Every TU must lie inside the H x W plane: the kernel writes only
    inside the plane, where the JAX scan's fixed 64x64 window would also
    have written into its padding. Positions and sizes must be multiples
    of 4 (the kernel finds a sample's writer by its 4x4 cell), and the
    TUs of one frame must not overlap (those of a stream never do)."""
    recs = np.stack([np.asarray(tus[k], np.int64) for k in FIELDS], axis=1)
    ty, tx, s = recs[:, 0], recs[:, 1], recs[:, 2]
    if len(recs) and ((ty < 0).any() or (tx < 0).any()
                      or (ty + s > H).any() or (tx + s > W).any()):
        raise ValueError("intra TU outside the plane")
    if ((ty | tx | s) & 3).any():
        raise ValueError("intra TU not aligned to the 4x4 grid")
    return recs.astype(np.int32)


def intra_levels(recs):
    """[N] int64 levels of the scan's dependency graph: a TU's level is 1
    plus the highest level among the earlier TUs that wrote one of its
    context samples (row ty-1 from tx to tx+toplen-1, column tx-1 from ty
    to ty+leftlen-1, and (ty-1, tx-1) under the cbx rule), 1 if there is
    none. TUs of one level are independent; levels.max() is the length of
    the chain that bounds the kernel. Host numpy, for tests and
    measurement scripts: the decode path never calls it."""
    recs = np.asarray(recs, np.int64).reshape(-1, NF)
    if not len(recs):
        return np.zeros(0, np.int64)
    # level of the TU that covers each 4x4 cell so far (0: none); the
    # margin takes the context of a TU at the far edge
    ch = int((recs[:, 0] + recs[:, 2]).max()) // 4 + 33
    cw = int((recs[:, 1] + recs[:, 2]).max()) // 4 + 33
    cells = np.zeros((ch, cw), np.int64)
    levels = np.zeros(len(recs), np.int64)
    for t, (ty, tx, s, _, toplen, leftlen, cbx) in enumerate(recs.tolist()):
        lvl = 0
        if ty > 0:
            x0 = tx - 1 if (cbx and tx > 0) else tx
            lvl = cells[(ty - 1) // 4,
                        x0 // 4:(tx + toplen - 1) // 4 + 1].max()
        if tx > 0:
            lvl = max(lvl, cells[ty // 4:(ty + leftlen - 1) // 4 + 1,
                                 (tx - 1) // 4].max())
        levels[t] = lvl + 1
        cells[ty // 4:(ty + s) // 4, tx // 4:(tx + s) // 4] = lvl + 1
    return levels


# ---------------------------------------------------------------------------
# Plain PyTorch version (mirrors jax_kernels.intra_scan step for step)
# ---------------------------------------------------------------------------

def _filt121(arr, n):
    """121 filter over the 128-sample context with edge replication at n
    (intra_prediction.c:39): prev index max(k-1, 0), next min(k+1, n-1)."""
    k = torch.arange(arr.shape[-1], device=arr.device)
    prev = arr[:, torch.clamp(k - 1, min=0)]
    nxt = arr[:, torch.clamp(k + 1, max=n - 1)]
    return (prev + 2 * arr + nxt + 2) >> 2


def _c127(x):
    return torch.clamp(x, 0, 127)


def _predict(left, top, tl, ty, tx, s, mode):
    """[C, s, s] prediction of C blocks of one size and mode (modes of
    common/intra_prediction.c:145-388; mode >= 10 folds to DC).
    left/top: [C, 128] int32 context; tl: [C]; ty/tx: the block position,
    ints when the C blocks are planes sharing one TU (the scans), or [C]
    tensors (the encoder's search over all blocks of a frame)."""
    dev = left.device
    i = torch.arange(s, device=dev)[:, None]
    j = torch.arange(s, device=dev)[None, :]
    C = left.shape[0]
    if mode == 0 or mode >= 10:                      # DC
        if torch.is_tensor(tx):
            lv = torch.where((tx != 0)[:, None], left, top)
            tv = torch.where((ty != 0)[:, None], top, left)
        else:
            lv = left if tx != 0 else top
            tv = top if ty != 0 else left
        dc = (lv[:, :s].sum(1) + tv[:, :s].sum(1) + s) // (2 * s)
        return dc.to(I32)[:, None, None].expand(C, s, s)
    if mode == 1:                                    # PLANAR
        kk = torch.arange(s, device=dev)

        def filt5(v):
            c = lambda a: torch.clamp(a, min=0)      # noqa: E731
            d = lambda a: torch.clamp(a, max=s - 1)  # noqa: E731
            return (v[:, c(kk - 2)] + 2 * v[:, c(kk - 1)] + 2 * v[:, kk]
                    + 2 * v[:, d(kk + 1)] + v[:, d(kk + 2)])
        topF, leftF = filt5(top), filt5(left)
        tlF = left[:, 1] + 2 * left[:, 0] + 2 * tl + 2 * top[:, 0] + top[:, 1]
        v = leftF[:, :, None] + topF[:, None, :] - tlF[:, None, None] + 4
        return clip255(torch.div(v, 8, rounding_mode="trunc"))
    if mode == 2:                                    # HOR
        return left[:, :s, None].expand(C, s, s)
    if mode == 3:                                    # VER
        return top[:, None, :s].expand(C, s, s)
    if mode in (5, 6):                               # UPRIGHT, UPUPRIGHT
        topF2 = _filt121(top, 2 * s)
        if mode == 5:
            return topF2[:, _c127(i + j + 1)]
        diag = i + 2 * j
        a = topF2[:, _c127((diag + 1) // 2)]
        b = (topF2[:, _c127(diag // 2)] + topF2[:, _c127(diag // 2 + 1)]) >> 1
        return torch.where((diag & 1) == 1, a, b)
    if mode == 9:                                    # DOWNLEFTLEFT
        leftF2 = _filt121(left, 2 * s)
        diag = 2 * i + j
        a = leftF2[:, _c127((diag + 1) // 2)]
        b = (leftF2[:, _c127(diag // 2)]
             + leftF2[:, torch.clamp(_c127(diag // 2 + 1), max=2 * s - 1)]
             ) >> 1
        return torch.where((diag & 1) == 1, a, b)

    leftF = _filt121(left, s)
    topF = _filt121(top, s)
    tlF = ((2 * tl + left[:, 0] + top[:, 0] + 2) >> 2)[:, None, None]
    if mode == 4:                                    # UPLEFT
        diag = i - j
        ad = _c127(torch.abs(diag) - 1)
        return torch.where(diag > 0, leftF[:, ad],
                           torch.where(diag == 0, tlF, topF[:, ad]))
    if mode == 7:                                    # UPUPLEFT
        diag = i - 2 * j
        nd = torch.abs(torch.clamp(diag, max=0))
        a_left = leftF[:, _c127(diag - 2)]
        hi = torch.clamp(nd // 2, max=s - 1)
        a_odd = topF[:, hi]
        a_even = (topF[:, hi] + topF[:, torch.clamp(nd // 2 - 1, min=0)]) >> 1
        return torch.where(
            diag > 1, a_left, torch.where(
                diag == 1, tlF, torch.where(
                    diag == 0, (tlF + topF[:, :1, None]) >> 1,
                    torch.where((nd & 1) == 1, a_odd, a_even))))
    # mode == 8, UPLEFTLEFT
    diag = 2 * i - j
    pd = torch.clamp(diag, min=0)
    a_top = topF[:, _c127(-diag - 2)]
    hi = torch.clamp(pd // 2, max=s - 1)
    a_odd = leftF[:, hi]
    a_even = (leftF[:, hi] + leftF[:, torch.clamp(pd // 2 - 1, min=0)]) >> 1
    return torch.where(
        diag < -1, a_top, torch.where(
            diag == -1, tlF, torch.where(
                diag == 0, (tlF + leftF[:, :1, None]) >> 1,
                torch.where((pd & 1) == 1, a_odd, a_even))))


def tu_context(P, rec):
    """(left [C, 128], top [C, 128], tl [C]) of one TU record on the
    planes P [C, Hp, Wp], zero-padded by PADI / PADE: top[k] =
    row[tx + min(k, toplen-1)] of the row above, left[k] likewise down the
    column to the left, 128 at the frame's top / left edge, and the
    top-left sample by the cbx rule (jax_kernels.intra_scan)."""
    ty, tx, _, _, toplen, leftlen, cbx = rec
    y, x = PADI + ty, PADI + tx
    k = torch.arange(128, device=P.device)
    full128 = torch.full((P.shape[0], 128), 128, dtype=I32, device=P.device)
    trow = P[:, y - 1, x - 1:x + 129]               # [C, 130]
    lcol = P[:, y:y + 128, x - 1]                   # [C, 128]
    top = full128 if ty == 0 else \
        trow[:, 1 + torch.clamp(k, max=toplen - 1)]
    left = full128 if tx == 0 else \
        lcol[:, torch.clamp(k, max=leftlen - 1)]
    tl = left[:, 0] if ty == 0 else (trow[:, 0] if cbx else top[:, 0])
    return left, top, tl


def intra_scan_plain(planes, resid, recs, count=None):
    """Sequential intra reconstruction over TU records in decode order.

    planes/resid: [C, H, W] int32 (C = 1 luma, or 2 for U+V, which share
    TU geometry); recs: [N, 7] int32; count: as intra_scan's. Returns the
    updated [C, H, W] int32 planes, each TU predicted from the context
    tu_context gives it."""
    intra_scan_plain.calls += 1
    recs = real_records(recs, count)
    C, H, W = planes.shape
    P = F.pad(planes.to(I32), (PADI, PADE, PADI, PADE))
    Rp = F.pad(resid.to(I32), (PADI, PADE, PADI, PADE))
    for rec in recs.tolist():
        ty, tx, s, mode = rec[:4]
        y, x = PADI + ty, PADI + tx
        left, top, tl = tu_context(P, rec)
        pred = _predict(left, top, tl, ty, tx, s, mode)
        P[:, y:y + s, x:x + s] = clip255(pred + Rp[:, y:y + s, x:x + s])
    return P[:, PADI:PADI + H, PADI:PADI + W].contiguous()


intra_scan_plain.calls = 0


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        L = _build.cuda_library("intra_scan")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        L.thor_intra_scan_count.restype = ci
        L.thor_intra_scan_count.argtypes = [vp, vp, vp, ci, ci, ci, vp, ci,
                                            vp, vp, vp]
        L.thor_cuda_error_string.restype = ctypes.c_char_p
        L.thor_cuda_error_string.argtypes = [ci]
        _lib = L
    return _lib


def scan_scratch(C: int, H: int, W: int, n: int, dev):
    """The kernel's scratch for n records on C planes of H x W: the unit
    ticket and count, the unit table (a TU of more than SLICE pixels is
    cut into slices, at most 8, and no more than the planes' pixels
    allow) and the owner map of the 4x4 cells. The kernel initialises it
    itself, on the stream."""
    cap = C * min(64 * 64 // SLICE * n, n + H * W // SLICE)
    return torch.empty(2 + cap + ((H + 3) // 4) * ((W + 3) // 4),
                       dtype=I32, device=dev)


def intra_scan(planes, resid, recs, count=None):
    """Intra scan of C planes sharing one TU record set.

    planes/resid: [C, H, W] int32; recs: [N, 7] int32 from
    build_intra_records; count: None (all N records are real) or a [1]
    int32 tensor on the same device, the number of real records at the
    head of recs (the rest pad a bucket: dec/fused.py). Returns the
    reconstructed [C, H, W] int32 planes. A CPU tensor takes the plain
    version; a CUDA tensor launches csrc/intra_scan.cu (which writes a
    copy of `planes` and reads `planes`, left as it was, wherever no
    earlier TU wrote).
    """
    if planes.device.type == "cpu":
        return intra_scan_plain(planes, resid, recs, count)
    if planes.device.type != "cuda":
        raise ValueError(f"intra_scan: unsupported device {planes.device}")
    check_current("intra_scan", planes.device)
    check_count("intra_scan", count, planes.device)
    if planes.dim() != 3 or resid.shape != planes.shape:
        raise ValueError("intra_scan: planes and resid must be [C, H, W]")
    for name, t in (("planes", planes), ("resid", resid), ("recs", recs)):
        if t.device != planes.device or t.dtype != I32 \
                or not t.is_contiguous():
            raise ValueError(f"intra_scan: {name} must be a contiguous "
                             f"int32 tensor on {planes.device}")
    if recs.dim() != 2 or recs.shape[1] != NF:
        raise ValueError(f"intra_scan: recs must be [N, {NF}]")
    C, H, W = planes.shape
    out = planes.clone()
    n = recs.shape[0]
    if n:
        L = _kernel()
        scratch = scan_scratch(C, H, W, n, planes.device)
        err = L.thor_intra_scan_count(
            planes.data_ptr(), out.data_ptr(), resid.data_ptr(), C, H, W,
            recs.data_ptr(), n, None if count is None else count.data_ptr(),
            scratch.data_ptr(),
            torch.cuda.current_stream(planes.device).cuda_stream)
        if err:
            raise RuntimeError("intra_scan launch failed: "
                               + L.thor_cuda_error_string(err).decode())
        intra_scan.launches += 1
    return out


intra_scan.launches = 0
