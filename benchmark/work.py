"""The least time the card could take for a kernel's work, and the
published peaks it is measured against.

The work is counted from a stream's own syntax (reference/decode.py's
syntax_counts), never from the program's records, so it counts the same
whatever kernel does it. The arithmetic re-derives the "Bound ms" column
of PERF.md's table of kernels (chip_smoke.py: enc_scan_bound), with the
layouts of the port's records left out:

  - kernel 6, encode_scan (encoder): per intra transform unit of size s
    in a plane, the original read and the reconstruction written at 4
    bytes a sample, the levels written at 2, the context read at 4
    (10 s^2 + 4 (2s + 1) bytes); the forward transform's two matrix
    stages on the kept min(s, 16) rows of a min(s, 32)-point block and,
    where the unit has a nonzero coefficient, the inverse's two stages.

The bound is the larger of bytes over the HBM rate and operations over
the integer rate; bound_kind says which of the two sets it.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80GB data sheet, at its 700 W power limit: HBM3
# bandwidth, and the float32 rate outside the tensor cores standing in
# for int32 (the data sheet gives no int32 rate)
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12

def bound_s(nbytes: float, ops: float) -> float:
    """The least seconds for `nbytes` moved once and `ops` operations."""
    return max(nbytes / HBM_BYTES_PER_S, ops / INT_OPS_PER_S)


def encode_scan_work(intra) -> tuple:
    """(bytes, operations) of kernel 6 over intra TU counts
    {(plane class, size, coded): n}."""
    nbytes = ops = 0
    for (_, s, coded), n in intra.items():
        q, m = min(s, 16), min(s, 32)
        nbytes += n * (10 * s * s + 4 * (2 * s + 1))
        fwd = 2 * (q * m * m + q * q * m)
        inv = 2 * (m * q * q + m * m * q) if coded else 0
        ops += n * (fwd + inv)
    return nbytes, ops


def bound_kind(nbytes: float, ops: float) -> str:
    """"bytes" or "operations": which term sets bound_s."""
    return "bytes" if nbytes / HBM_BYTES_PER_S >= ops / INT_OPS_PER_S \
        else "operations"
