"""The traced sub-window: torch.profiler (CPU and CUDA activities) over a
bounded piece of a cell's traffic, reduced to what the per-layer readers
read.

Traced(): the profiler over its block, with the block marked by a span of
its own (WINDOW_SPAN), so that the window's start and end come from the
same clock as the events. reduce() turns the kineto events into a Trace:
the device's operations (kernels, copies, sets) as (name, start, end) in
ns, the host calls that queued work on the card, and the benchmark's own
spans. The reduction is frozen here, so that a later change of the
program cannot move it:

  - busy time is the union of the device operations' intervals inside the
    window (operations of two streams that overlap count once);
  - a kernel's time is the sum of the intervals of the device operations
    whose names a reader selects.
"""

from __future__ import annotations

import contextlib

WINDOW_SPAN = "bench.traced_window"
# CUPTI's own buffer requests show as device events: not the card's work
NOT_DEVICE_WORK = ("Activity Buffer Request",)
NAME_CHARS = 100        # device operations' names in the breakdown


class Trace:
    """What one traced sub-window recorded.

    device: [(name, start_ns, end_ns)] of the card's operations, clipped
    to the window; host: [(name, start_ns, end_ns, thread)] of the host's
    events; window: (start_ns, end_ns); frames: the frames the traffic
    completed in it; extra: the traffic's own readings (work
    counts, encoder stage times)."""

    def __init__(self, device, host, window, frames, extra=None):
        self.device, self.host, self.window = device, host, window
        self.frames = frames
        self.extra = dict(extra or {})

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_s(self) -> float:
        """Seconds in which at least one device operation ran."""
        return union_ns([(a, b) for _, a, b in self.device]) / 1e9

    def idle_share(self) -> float | None:
        """1 - busy / window, or None where the card ran nothing."""
        busy = self.busy_s()
        if busy <= 0 or self.window_s <= 0:
            return None
        return 1.0 - busy / self.window_s

    def kernel_s(self, select) -> float:
        """Seconds of the device operations whose name `select` accepts."""
        return sum(b - a for name, a, b in self.device if select(name)) / 1e9

    def breakdown(self, top: int = 10) -> dict:
        """{"device_ops": the `top` device operations by summed seconds,
        "idle_gaps": the `top` longest gaps in which the card ran nothing,
        each named by the innermost host event spanning its middle}."""
        by = {}
        for name, a, b in self.device:
            name = name[:NAME_CHARS]
            by[name] = by.get(name, 0.0) + (b - a) / 1e9
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        t = self.window[0]
        for a, b in merged([(a, b) for _, a, b in self.device]) + [
                (self.window[1], self.window[1])]:
            if a > t:
                gaps.append((a - t, t, a))
            t = max(t, b)
        gaps.sort(reverse=True)
        named = []
        for dur, a, b in gaps[:top]:
            mid = (a + b) // 2
            inner = [(e - s, name) for name, s, e, _ in self.host
                     if s <= mid <= e and name != WINDOW_SPAN]
            named.append([min(inner)[1] if inner else "host: no traced event",
                          dur / 1e9])
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}


def merged(intervals):
    """The union of [a, b) intervals as sorted disjoint intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def union_ns(intervals) -> int:
    return sum(b - a for a, b in merged(intervals))


@contextlib.contextmanager
def traced(cuda: bool):
    """torch.profiler over the block (CUDA activities where `cuda`),
    inside a span named WINDOW_SPAN; yields a holder whose .events are
    set, as kineto events, when the block ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    holder = _Holder()
    with profile(activities=acts) as prof:
        with record_function(WINDOW_SPAN):
            yield holder
            if cuda:
                torch.cuda.synchronize()
    holder.events = prof.profiler.kineto_results.events()


class _Holder:
    events = None


def _annotation(e) -> bool:
    """A host span mirrored onto the device's timeline (the profiler's
    "gpu_user_annotation"): it covers the device work it launched and is
    no work itself."""
    kind = getattr(e, "activity_type", None)
    kind = kind() if callable(kind) else kind
    return e.name() == WINDOW_SPAN or "annotation" in str(kind).lower() \
        or bool(getattr(e, "is_user_annotation", lambda: False)())


def reduce(events, frames: int, extra=None) -> Trace:
    """A Trace from the kineto events of one traced() block."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    window = None
    for e in events:
        if e.name() == WINDOW_SPAN:
            window = (e.start_ns(), e.start_ns() + e.duration_ns())
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    lo, hi = window
    device, host = [], []
    for e in events:
        a = e.start_ns()
        b = a + e.duration_ns()
        if b <= lo or a >= hi:
            continue
        if e.device_type() == cuda:
            if (b > a and e.name() not in NOT_DEVICE_WORK
                    and not _annotation(e)):
                device.append((e.name(), max(a, lo), min(b, hi)))
        else:
            host.append((e.name(), a, b, e.start_thread_id()))
    return Trace(device, host, window, frames, extra)
