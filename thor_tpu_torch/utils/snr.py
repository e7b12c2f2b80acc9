"""PSNR computation (common/snr.c:32-89): -10*log10(MSE/255^2) per
plane; infinite for identical planes (the reference prints `inf` too)."""

from __future__ import annotations

import math

import numpy as np


def snr_plane(org: np.ndarray, rec: np.ndarray) -> float:
    d = org.astype(np.int64) - rec.astype(np.int64)
    sumsqr = float((d * d).sum())
    plse = sumsqr / (65025.0 * org.shape[0] * org.shape[1])
    return -10.0 * math.log10(plse) if plse > 0 else float("inf")


def snr_yuv(org, rec):
    """Returns (psnr_y, psnr_u, psnr_v) for (y, u, v) plane tuples."""
    return tuple(snr_plane(o, r) for o, r in zip(org, rec))
