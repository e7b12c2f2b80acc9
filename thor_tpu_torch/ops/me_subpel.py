"""The motion search's quarter-pel step (enc/device_me): its plain version,
the MV rate it shares with the rest of the search, and the wrapper of the
hand-written kernel csrc/me_subpel.cu.

Counterpart of thor_tpu/enc/device_me.py:_subpel_step, which has no TPU
kernel (XLA ops there). The plain version (_subpel) materializes every
phase's tap products of every block's window; the kernel keeps the
window in shared memory and the sums in registers. Both give the same
integers: the tolerance is exact equality.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import check_current
from . import _build
from .kernels import const
from .windowed import banded_windows

PAD = 96            # luma reference padding (PADDING_Y)
M_SUB = 40          # |full-pel MV| the step starts from (device_me.M_SEL)
SIZES = (8, 16, 32, 64)

I32 = torch.int32


def _mv_comp_bits(d):
    """quote_vlc(10, 2|d| - (d < 0)) code length (enc/putvlc.c:205):
    1 + 2 * floor(log2(cn + 1))."""
    cn = 2 * d.abs() - (d < 0).to(I32)
    e = torch.frexp((cn + 1).to(torch.float32)).exponent.to(I32)
    return 1 + 2 * (e - 1)


def _mv_bits(dx, dy):
    return _mv_comp_bits(dx) + _mv_comp_bits(dy)


def _rate(lam_me, bits):
    """(lam_me * bits + 0.5) in float32, truncated to int32."""
    return (lam_me * bits.to(torch.float32) + 0.5).to(I32)


def _first_min(cost):
    """(min, index) over dim 0 of [C, ...]; a tie keeps the first
    (torch.argmin's rule)."""
    i = torch.argmin(cost, dim=0)
    return cost.gather(0, i[None])[0], i.to(I32)


def _subpel(ob, refp, lut, mvy, mvx, b, lam_me, py, px):
    """Exact 7 x 7 quarter-pel step around full-pel (mvy, mvx) with the
    rate against the quarter-pel predictor (py, px). The 16 phase planes
    of each block's window are interpolated in the window (int32 tap sums,
    floor((acc + 2048) / 4096), clip). Returns quarter-pel (mvy, mvx,
    cost). The plain version of subpel_search."""
    _subpel.calls += 1
    gf = banded_windows(refp, mvy, mvx, PAD - 3, PAD - 3, b, b + 7,
                        M_SUB).to(I32)
    view = gf.unfold(2, b + 2, 1).unfold(3, b + 2, 1)  # [HB,WB,6,6,b+2,b+2]
    lut_t = const(np.asarray(lut, np.int32), ob.device)
    # sads[p, oy, ox]: phase p's prediction at window offset (oy, ox)
    sads = []
    for p in range(16):
        acc = (lut_t[p][:, :, None, None] * view).sum(dim=(2, 3), dtype=I32)
        pw = torch.clamp((acc + 2048) >> 12, 0, 255)
        pv = pw[:, :, :b + 1, :b + 1].unfold(2, b, 1).unfold(3, b, 1)
        sads.append((ob[:, :, None, None] - pv).abs().sum(dim=(4, 5),
                                                         dtype=I32))
    sads = torch.stack(sads)                           # [16, HB, WB, 2, 2]
    q = [(qy, qx) for qy in range(-3, 4) for qx in range(-3, 4)]
    sel = torch.stack([sads[(qy & 3) * 4 + (qx & 3), :, :, 1 + (qy >> 2),
                            1 + (qx >> 2)] for qy, qx in q])
    qy = const(np.array([a for a, _ in q], np.int32), ob.device)
    qx = const(np.array([c for _, c in q], np.int32), ob.device)
    cy = 4 * mvy + qy[:, None, None]
    cx = 4 * mvx + qx[:, None, None]
    best, i = _first_min(sel + _rate(lam_me, _mv_bits(cx - px, cy - py)))
    i = i[None].long()
    return cy.gather(0, i)[0], cx.gather(0, i)[0], best


_subpel.calls = 0

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        L = _build.cuda_library("me_subpel")
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        L.thor_me_subpel.restype = ci
        L.thor_me_subpel.argtypes = [vp, ci, ci, ci, vp, ll, ll, ll, ll, vp,
                                     vp, vp, vp, vp, ci, ci, ci, ci, vp, vp,
                                     vp]
        L.thor_cuda_error_string.restype = ctypes.c_char_p
        L.thor_cuda_error_string.argtypes = [ci]
        _lib = L
    return _lib


def _check(ob, refpad, lut, mvy, mvx, b, lam_me, py, px):
    if b not in SIZES:
        raise ValueError(f"subpel_search: block size {b} is not one of "
                         f"{SIZES}")
    if refpad.dim() != 3 or refpad.dtype != torch.uint8:
        raise ValueError("subpel_search: refpad must be [R, Hp, Wp] uint8")
    R = refpad.shape[0]
    if mvy.dim() != 3 or mvy.shape[0] != R:
        raise ValueError("subpel_search: mvy, mvx must be [R, HB, WB]")
    HB, WB = mvy.shape[1:]
    for name, t, shape in (("ob", ob, (HB, WB, b, b)),
                           ("mvy", mvy, (R, HB, WB)),
                           ("mvx", mvx, (R, HB, WB)), ("py", py, (HB, WB)),
                           ("px", px, (HB, WB))):
        if tuple(t.shape) != shape or t.dtype != I32:
            raise ValueError(f"subpel_search: {name} must be {shape} int32")
    if np.shape(lut) != (16, 6, 6):
        raise ValueError("subpel_search: lut must be [16, 6, 6]")
    if lam_me.numel() != 1 or lam_me.dtype != torch.float32:
        raise ValueError("subpel_search: lam_me must be one float32")
    dev = refpad.device
    if any(t.device != dev for t in (ob, mvy, mvx, lam_me, py, px)):
        raise ValueError("subpel_search: the tensors lie on more than one "
                         "device")


def subpel_search(ob, refpad, lut, mvy, mvx, b: int, lam_me, py, px):
    """The exact 7 x 7 quarter-pel step of every reference at once.

    ob: [HB, WB, b, b] int32, the blocks' samples (any strides: a view of
    the frame does); refpad: [R, Hp, Wp] uint8 padded references; lut:
    [16, 6, 6] int32 (numpy); mvy, mvx: [R, HB, WB] int32 full-pel MVs,
    |mv| <= M_SUB; lam_me: one float32; py, px: [HB, WB] int32 quarter-pel
    predictors; b: 8, 16, 32 or 64. Returns quarter-pel (mvy, mvx, cost),
    each [R, HB, WB] int32. A CPU tensor runs _subpel reference by
    reference; a CUDA tensor launches csrc/me_subpel.cu once for every
    reference, with no wait for the host."""
    _check(ob, refpad, lut, mvy, mvx, b, lam_me, py, px)
    dev = refpad.device
    if dev.type == "cpu":
        per = [_subpel(ob, refpad[r], lut, mvy[r], mvx[r], b, lam_me, py, px)
               for r in range(refpad.shape[0])]
        return tuple(torch.stack([v[j] for v in per]) for j in range(3))
    if dev.type != "cuda":
        raise ValueError(f"subpel_search: unsupported device {dev}")
    check_current("subpel_search", dev)
    if lam_me.data_ptr() % 4:
        raise ValueError("subpel_search: lam_me must be 4-byte aligned")
    R, Hp, Wp = refpad.shape
    HB, WB = mvy.shape[1:]
    ref = refpad.contiguous()
    mvy, mvx, py, px = (t.contiguous() for t in (mvy, mvx, py, px))
    lut_h = np.ascontiguousarray(lut, np.int32)
    out = torch.empty((3, R, HB, WB), dtype=I32, device=dev)
    if not out.numel():
        return out[0], out[1], out[2]
    L = _kernel()
    err = L.thor_me_subpel(
        ref.data_ptr(), R, Hp, Wp, ob.data_ptr(), *ob.stride(),
        mvy.data_ptr(), mvx.data_ptr(), py.data_ptr(), px.data_ptr(),
        lam_me.data_ptr(), HB, WB, b, PAD - 3, lut_h.ctypes.data,
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("subpel_search launch failed: "
                           + L.thor_cuda_error_string(err).decode())
    subpel_search.launches += 1
    return out[0], out[1], out[2]


subpel_search.launches = 0
