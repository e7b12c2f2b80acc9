"""Exact bit cost of the coefficient VLC coding, batched over blocks.

Counterpart of thor_tpu/ops/coeff_bits.py: a vectorized mirror of
write_coeff's two-state level/run automaton (enc/write_bits.c:110-253)
and the quote_vlc tables it uses (enc/putvlc.c:133-229). thor_tpu walks
the zigzag positions in a loop, all blocks side by side; here the state
at every position comes from cumulative maxima over the positions, so one
call is a few dozen tensor ops whatever the block size. Plain tensor ops,
as the JAX package runs it as XLA ops.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codec.constants import zigzag_for
from .kernels import const

I32 = torch.int32


def _flog2(x):
    """floor(log2(x)) for int x >= 1, through the float32 exponent: exact
    below 2^24, far above any level or code number here."""
    return torch.frexp(x.to(torch.float32))[1].to(I32) - 1


def _qv0(v):
    """quote_vlc(0, v)."""
    return torch.where(v < 6, 1 + v,
                       7 + 2 * _flog2(torch.clamp(v - 5, min=1)))


def _qv1(v):
    """quote_vlc(1, v)."""
    return torch.where(v < 12, 2 + (v >> 1),
                       6 + 2 * _flog2(torch.clamp(v - 10, min=1)))


def _qv2(v):
    """quote_vlc(2, v)."""
    return torch.where(v < 24, 3 + (v >> 2),
                       5 + 2 * _flog2(torch.clamp(v - 20, min=1)))


def _qv10(v):
    """quote_vlc(10, v)."""
    return 1 + 2 * _flog2(v + 1)


def _find_code(run, lv, maxrun, chroma: bool):
    """find_code(run, level, maxrun, chroma_flag, eob=0)
    (enc/write_bits.c:71-108)."""
    maxrun2 = torch.clamp(maxrun, min=4)
    index = run + (lv > 1).to(I32) * (maxrun2 + 1)
    cn = torch.where(
        index <= 4, index + 1,
        torch.where(index <= maxrun2, index + 3,
                    torch.where(index == maxrun2 + 1, 6,
                                torch.where(index == maxrun2 + 2, 7,
                                            index + 1))))
    if not chroma:
        cn = torch.where(index < 2, index, cn)
    return cn


def _run_code_bits(cn, chroma: bool, small: bool):
    """Bits of the run/level codeword (enc/write_bits.c:201-210)."""
    if chroma and small:
        return _qv10(cn)
    return torch.where(cn == 0, 2, _qv2(cn + 1))


def _last_before(ev):
    """[n, P] bool events -> [n, P + 1] int64: for each position p
    (0..P), the last index q < p with ev[q], or -1."""
    n, P = ev.shape
    idx = torch.where(ev, torch.arange(P, device=ev.device), -1)
    last = torch.cummax(idx, dim=1).values
    return torch.cat([torch.full((n, 1), -1, dtype=last.dtype,
                                 device=ev.device), last], dim=1)


def coeff_bits_batch(q, size: int, intra: bool, chroma: bool):
    """Exact write_coeff bit count of [N, size, size] quantized blocks ->
    [N] int32. Meaningful only for a block with a nonzero coefficient (the
    stream never carries an all-zero coefficient block).

    The automaton's state at each zigzag position is a function of the
    levels before it, each part set by the last position of one kind:
    level mode by the last level that is not 1 (0 leaves it, above 1
    enters it; 1 keeps the mode), the run by the last position that was in
    level mode or nonzero, maxrun by the last start of a run span, the
    luma VLC table by the last level-mode level. So every position's state,
    and its bits, come from a few cumulative maxima over all positions at
    once, with no loop over them."""
    qsize = min(size, 16)
    Nc = qsize * qsize
    dev = q.device
    zz = const(np.asarray(zigzag_for(qsize), np.int64), dev)
    small = size <= 8
    eob_bits = 1 if (chroma and small) else (2 if chroma else 3)

    n = q.shape[0]
    block = q[:, :qsize, :qsize].reshape(n, Nc).to(I32)
    sco = torch.zeros_like(block)
    sco[:, zz] = block
    pidx = torch.arange(Nc, dtype=I32, device=dev)
    last_pos = torch.clamp(
        torch.where(sco != 0, pidx[None, :], -1).amax(dim=1), min=0)
    lv = sco.abs()
    is_z = lv == 0
    ar = torch.arange(Nc + 1, device=dev)

    def at(a, where_):
        """a[row, where_] for where_ >= 0 (a: [n, Nc])."""
        return a.gather(1, torch.clamp(where_, min=0))

    # level mode at positions 0..Nc (True before any level other than 1)
    ev = _last_before(lv != 1)
    lm_all = (ev < 0) | (at(lv, ev) > 1)
    lm = lm_all[:, :Nc]
    # the run: zeros coded in run mode since the last reset
    reset = _last_before(lm | ~is_z)[:, :Nc]
    run = (ar[None, :Nc] - 1 - reset).to(I32)
    # maxrun: Nc - q - 2 of the last run-span start q, else 0
    new_span = (lm & is_z) | (~lm & ~is_z & (lv <= 1))
    span = _last_before(new_span)[:, :Nc]
    maxrun = torch.where(span >= 0, Nc - span - 2, 0).to(I32)
    # the luma VLC table of level mode: set by the last level-mode level
    vlc0 = bool(intra and not chroma)
    if chroma:
        vlc_all = torch.full((n, Nc + 1), vlc0, dtype=torch.bool, device=dev)
    else:
        lmq = _last_before(lm)
        vlc_all = torch.where(lmq < 0, vlc0, at(lv, lmq) > 3)
    vlc = vlc_all[:, :Nc]

    lv_bits = torch.where(vlc, _qv1(lv), _qv0(lv)) + (lv > 0)
    cn = _find_code(run, lv, maxrun, chroma)
    sgn = (sco < 0).to(I32)
    lvl_bits = torch.where(
        lv > 1, _qv0(2 * torch.clamp(lv - 2, min=0) + sgn), 1)
    run_bits = _run_code_bits(cn, chroma, small) + lvl_bits
    nbits = torch.where(lm, lv_bits, torch.where(is_z, 0, run_bits))
    active = pidx[None, :] <= last_pos[:, None]
    bits = torch.where(active, nbits, 0).sum(dim=1, dtype=I32)

    # tail zero in level mode + EOB (enc/write_bits.c:231-252), from the
    # state after the last coefficient
    end = (last_pos + 1).long()[:, None]
    lm_end = lm_all.gather(1, end)[:, 0]
    vlc_end = vlc_all.gather(1, end)[:, 0]
    tail = lm_end & (last_pos + 1 < Nc)
    bits = bits + torch.where(tail, torch.where(vlc_end, 2, 1), 0)
    pos_after = last_pos + 1 + tail.to(I32)
    bits = bits + torch.where(pos_after < Nc, eob_bits, 0)
    if chroma:
        shortcut = (last_pos == 0) & (sco[:, 0].abs() == 1)
        bits = torch.where(shortcut, 2, bits + 1)
    return bits.to(I32)
