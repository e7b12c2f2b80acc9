"""device_idle.encode: the share of the traced encode sub-window in which
the card ran no operation, from the union of the operations' intervals
over all streams."""

from benchmark.metrics._common import idle_pct


def read(trace):
    return idle_pct(trace)
