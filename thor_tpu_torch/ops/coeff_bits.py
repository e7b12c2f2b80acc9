"""Exact bit cost of the coefficient VLC coding, batched over blocks.

Counterpart of thor_tpu/ops/coeff_bits.py: a vectorized mirror of
write_coeff's two-state level/run automaton (enc/write_bits.c:110-253)
and the quote_vlc tables it uses (enc/putvlc.c:133-229). One loop walks
the zigzag positions while all blocks advance through the automaton side
by side. Plain tensor ops, as the JAX package runs it as XLA ops.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codec.constants import zigzag_for

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


def coeff_bits_batch(q, size: int, intra: bool, chroma: bool):
    """Exact write_coeff bit count of [N, size, size] quantized blocks ->
    [N] int32. Meaningful only for a block with a nonzero coefficient (the
    stream never carries an all-zero coefficient block)."""
    qsize = min(size, 16)
    Nc = qsize * qsize
    dev = q.device
    zz = torch.as_tensor(np.asarray(zigzag_for(qsize)), dtype=torch.long,
                         device=dev)
    small = size <= 8
    eob_bits = 1 if (chroma and small) else (2 if chroma else 3)

    n = q.shape[0]
    block = q[:, :qsize, :qsize].reshape(n, Nc).to(I32)
    sco = torch.zeros_like(block)
    sco[:, zz] = block
    pidx = torch.arange(Nc, dtype=I32, device=dev)
    last_pos = torch.clamp(
        torch.where(sco != 0, pidx[None, :], -1).amax(dim=1), min=0)
    scoT = sco.t().contiguous()                   # [Nc, N]: a row per step

    bits = torch.zeros(n, dtype=I32, device=dev)
    lm = torch.ones(n, dtype=torch.bool, device=dev)       # level mode
    vlc = torch.full((n,), bool(intra and not chroma), dtype=torch.bool,
                     device=dev)
    run = torch.zeros(n, dtype=I32, device=dev)
    maxrun = torch.zeros(n, dtype=I32, device=dev)

    # positions past every block's last coefficient change no state
    steps = int(last_pos.max()) + 1 if n else 0
    for p in range(steps):
        v = scoT[p]
        lv = v.abs()
        active = last_pos >= p
        is_z = lv == 0
        # level mode
        lv_bits = torch.where(vlc, _qv1(lv), _qv0(lv)) + (lv > 0)
        # run mode
        cn = _find_code(run, lv, maxrun, chroma)
        sgn = (v < 0).to(I32)
        lvl_bits = torch.where(
            lv > 1, _qv0(2 * torch.clamp(lv - 2, min=0) + sgn), 1)
        run_bits = _run_code_bits(cn, chroma, small) + lvl_bits
        nbits = torch.where(lm, lv_bits, torch.where(is_z, 0, run_bits))
        # state updates. A run span starts when level mode emitted a zero
        # or run mode coded a level-1 coefficient: maxrun = Nc - (p+1) - 1
        new_span = (lm & is_z) | (~lm & ~is_z & (lv <= 1))
        lm2 = torch.where(lm, lv > 0, lv > 1)
        run2 = torch.where(lm | ~is_z, 0, run + 1)
        maxrun2 = torch.where(new_span, Nc - p - 2, maxrun)
        bits = bits + torch.where(active, nbits, 0)
        if not chroma:
            vlc = torch.where(active & lm, lv > 3, vlc)
        lm = torch.where(active, lm2, lm)
        run = torch.where(active, run2, run)
        maxrun = torch.where(active, maxrun2, maxrun)

    # tail zero in level mode + EOB (enc/write_bits.c:231-252)
    tail = lm & (last_pos + 1 < Nc)
    bits = bits + torch.where(tail, torch.where(vlc, 2, 1), 0)
    pos_after = last_pos + 1 + tail.to(I32)
    bits = bits + torch.where(pos_after < Nc, eob_bits, 0)
    if chroma:
        shortcut = (last_pos == 0) & (sco[:, 0].abs() == 1)
        bits = torch.where(shortcut, 2, bits + 1)
    return bits.to(I32)
