"""Motion compensation of blocks that each carry one motion vector.

Counterpart of thor_tpu/ops/banded_mc.py: the prediction the encoder's
subpel search and trial coding score. Each block's full-pel window of
(b + T - 1)^2 samples comes from ops/windowed (an indexed load), its
phase selects one [T, T] row of the combined tap LUT, and the taps sum in
int32: thor_tpu sums the same products in float32, where every partial sum
is an integer below 2^24, so the two are equal. The rounding is
floor((acc + 2048) / 4096), an arithmetic shift by 12 (a floor also for a
negative acc). The final reconstruction does not use this module: it runs
the decoder's MC (ops/mc.mc_frame, the CUDA kernel on a card).
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels import const
from .windowed import banded_windows_stack

#: full-pel window-origin bounds: the device ME emits |mv| <= 163
#: quarter-pel, so luma (mv >> 2) - 2 lies in [-43, 38] and chroma
#: (mv >> 3) - 1 in [-22, 19]; origins past them are clamped to them
M_LUMA = 44
M_CHROMA = 24

I32 = torch.int32


def mc_pred_banded(refpads, slot, mvy, mvx, lut, pad: int, frac_bits: int,
                   b: int, tap_lo: int, M: int):
    """[HB, WB, b, b] int32 prediction (0..255) of per-block constant MVs.

    refpads: [R, Hp, Wp] uint8 codec-padded planes; slot, mvy, mvx:
    [HB, WB] int32 (MVs sign-folded, in 1/2^frac_bits pel of this plane);
    lut: [P, T, T] numpy combined tap weights."""
    lut = np.asarray(lut)
    P, T, _ = lut.shape
    fm = (1 << frac_bits) - 1
    phase = (mvy & fm) * (fm + 1) + (mvx & fm)
    ivy = torch.clamp((mvy >> frac_bits) + tap_lo, -M, M)
    ivx = torch.clamp((mvx >> frac_bits) + tap_lo, -M, M)
    win = banded_windows_stack(refpads, slot, ivy, ivx, pad, pad, b,
                               b + T - 1, M).to(I32)
    taps = const(lut.astype(np.int32), refpads.device)[
        phase.long()]                                    # [HB, WB, T, T]
    # view [HB, WB, T, T, b, b]: tap (m, n) of output (i, j) is
    # win[m + i, n + j]
    view = win.unfold(2, b, 1).unfold(3, b, 1)
    acc = (taps[..., None, None] * view).sum(dim=(2, 3), dtype=I32)
    return torch.clamp((acc + 2048) >> 12, 0, 255)
