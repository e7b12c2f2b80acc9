"""Coefficient blocks built to fire the quantizer's zero-run pass, for
the tests of the pass (tests/test_torch_enc_ops.py against thor_tpu's
XLA form, tests/test_torch_enc_fused.py's card cases) and for
chip_smoke.py's check of csrc/rdoq.cu. numpy only: the card's machine
has no JAX."""

import numpy as np

from thor_tpu_torch.codec.constants import zigzag_for


def trigger_blocks(rng, size, qp, n):
    """Scan-order coefficient blocks built to fire the zero-run pass: a
    level above 1 after two zeros, with the three raw magnitudes ordered
    so that each of the three moves (current, one back, two back) is
    taken, and levels 3 / 4 back that veto it."""
    qs = min(size, 16)
    Nc = qs * qs
    step = max(1, (1 << (21 - int(np.log2(size)) + qp // 6))
               // int([26214, 23302, 20560, 18396, 16384, 14564][qp % 6]))
    sco = np.zeros((n, Nc), np.int32)
    for b in range(n):
        p = 2
        while p < Nc - 1:
            p += int(rng.integers(2, 7))
            if p >= Nc:
                break
            kind = int(rng.integers(0, 5))
            sco[b, p] = int(rng.choice([-1, 1])) * step * int(
                rng.integers(2, 5))
            lo = max(1, step // 8)
            if kind == 0:                  # all tiny: move the current
                sco[b, p] = int(rng.choice([-1, 1])) * (2 * step + 1)
                sco[b, p - 1] = int(rng.integers(-lo, lo + 1))
            elif kind == 1:                # one back is the larger
                sco[b, p - 1] = int(rng.choice([-1, 1])) * (step // 2)
                sco[b, p - 2] = int(rng.integers(-lo, lo + 1))
            elif kind == 2:                # two back is the larger
                sco[b, p - 2] = int(rng.choice([-1, 1])) * (step // 2)
                sco[b, p - 1] = int(rng.integers(-lo, lo + 1))
            elif kind == 3 and p >= 3:     # veto by a big level 3 back
                sco[b, p - 3] = 3 * step
            # kind 4: leave as is
    zz = np.asarray(zigzag_for(qs))
    blk = np.zeros((n, size, size), np.int32)
    blk[:, :qs, :qs] = sco[:, zz].reshape(n, qs, qs)
    return blk
