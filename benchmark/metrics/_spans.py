"""Shared pieces of the span readers: the card's idle time in the traced
window set against the program's own host spans (thor_tpu_torch's
utils/tracing.span: enc.<stage>, enc.<stage>.<child>, enc.frame.<kind>).

The idle intervals are the window less the union of the device's
operations (benchmark.trace.merged); a span's idle is their intersection
with the union of the host events of its name, so a stage that runs
twice in a frame counts once where its events overlap."""

from __future__ import annotations

from benchmark.trace import merged

FRAME = "enc.frame."
P_FRAMES = ("enc.frame.P", "enc.frame.B")
I_FRAMES = ("enc.frame.I",)


def idle_intervals(trace):
    """The window's intervals in which the card ran no operation, sorted
    and disjoint (ns)."""
    lo, hi = trace.window
    out, t = [], lo
    for a, b in merged([(a, b) for _, a, b in trace.device]):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def host_union(trace, select):
    """The union of the host events whose name `select` accepts, clipped
    to the window (ns)."""
    lo, hi = trace.window
    return merged([(max(a, lo), min(b, hi)) for name, a, b, _ in trace.host
                   if select(name) and b > lo and a < hi])


def overlap_ns(xs, ys) -> int:
    """The length of the intersection of two sorted disjoint interval
    lists."""
    total, i, j = 0, 0, 0
    while i < len(xs) and j < len(ys):
        a = max(xs[i][0], ys[j][0])
        b = min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def count(trace, names) -> int:
    """Host events named one of `names`."""
    return sum(name in names for name, _, _, _ in trace.host)


def idle_ms_per_frame(trace, span, frames):
    """Idle ms under the host events named `span`, per frame span named
    one of `frames`; None where the trace holds no such span or frame."""
    n = count(trace, frames)
    if n == 0 or count(trace, (span,)) == 0:
        return None
    under = overlap_ns(idle_intervals(trace),
                       host_union(trace, lambda name: name == span))
    return under / 1e6 / n


def is_stage(name) -> bool:
    """An encoder stage or child span (not a frame span)."""
    return name.startswith("enc.") and not name.startswith(FRAME)


def unspanned_pct(trace):
    """The share in % of the window's idle time under no stage or child
    span; None where the trace holds no stage span or no idle time."""
    if not any(is_stage(name) for name, _, _, _ in trace.host):
        return None
    idle = idle_intervals(trace)
    total = sum(b - a for a, b in idle)
    if total <= 0:
        return None
    return 100.0 * (total - overlap_ns(idle, host_union(trace, is_stage))) \
        / total
