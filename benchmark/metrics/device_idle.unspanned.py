"""device_idle.unspanned: the share in % of the traced window's idle
time (no device operation running) that no encoder stage or child span
(enc.*, the frame spans enc.frame.* left out) covers: what the program's
spans cannot yet name."""

from benchmark.metrics._spans import unspanned_pct


def read(trace):
    return unspanned_pct(trace)
