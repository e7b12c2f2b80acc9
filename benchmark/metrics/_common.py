"""Shared pieces of the per-layer readers."""

from __future__ import annotations

from benchmark.work import bound_s


def roofline(trace, select, nbytes, ops):
    """The share in % of a kernel's device time that the least time for
    its work (work.bound_s) would take; None where the work or the
    kernel's time is nought."""
    if nbytes <= 0 and ops <= 0:
        return None
    t = trace.kernel_s(select)
    if t <= 0:
        return None
    return 100.0 * bound_s(nbytes, ops) / t


def stage_ms(trace, stage, frames=lambda ft: True):
    """Mean ms of an encoder stage (Encoder.frame_times[...][stage]) over
    the window's frames that `frames` selects and that have it."""
    vals = [ft[stage] for ft in trace.extra.get("frame_times", [])
            if stage in ft and frames(ft)]
    return 1e3 * sum(vals) / len(vals) if vals else None


def idle_pct(trace):
    """The device's idle share of the traced window in %: one minus the
    union of its operations' intervals over the window."""
    share = trace.idle_share()
    return None if share is None else 100.0 * share


def is_p_frame(ft):
    """A device P/B frame's stage times (its measure program ran)."""
    return "measure" in ft
