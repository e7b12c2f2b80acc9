"""Tracing and profiling hooks.

Counterpart of thor_tpu/utils/tracing.py. span() is the one span
primitive: it keeps a stage's host-clock seconds in a dict and, while a
torch.profiler records, opens a range of the stage's name, a host event
on the clock of the device's kernels and copies (the encoder's stages,
enc.*, are spans). StageTimer keeps the host's wall clock per named stage
(parse, input build, device step, output) with thor_tpu's report; each
stage is a span, and on a timer made for a CUDA device also an NVTX
range, so a trace and an Nsight timeline name the stages. device_trace
is torch.profiler with CPU (and, on a card, CUDA) activities, written as
a Chrome trace. count_wait() counts, per thread, the places where the
encoder needs a device result on the host (waits() reads the count);
host_waits counts the calls that make the host wait for the card
(torch.cuda.set_sync_debug_mode), by the line that made them.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import warnings
from collections import Counter, defaultdict

import torch

from ..device import resolve_device


@contextlib.contextmanager
def span(name: str, times=None, key=None, args=None):
    """A stage named `name` over the block: its host-clock seconds are
    added to times[key] (where times is given), and while a
    torch.profiler records on this thread the block is a range of that
    name (record_function, with the string `args`). With no profiler on it
    costs a flag test and two clock reads."""
    rf = None
    if torch.autograd._profiler_enabled():
        rf = torch.profiler.record_function(name, args)
        rf.__enter__()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if times is not None:
            times[key] = times.get(key, 0.0) + dt
        if rf is not None:
            rf.__exit__(None, None, None)


_WAITS = threading.local()


def count_wait():
    """Count one place where this thread's host needs a device result
    (on the CPU too, so that a CPU run counts what a card's would)."""
    _WAITS.n = getattr(_WAITS, "n", 0) + 1


def waits() -> int:
    """The waits count_wait() counted on this thread so far."""
    return getattr(_WAITS, "n", 0)


class StageTimer:
    """Accumulates wall-clock per named pipeline stage. device: the
    device the stages run on (None: the host only); a CUDA device adds an
    NVTX range per stage."""

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        nvtx = self.device is not None and self.device.type == "cuda"
        with span(name, self.totals, name):
            if nvtx:
                torch.cuda.nvtx.range_push(name)
            try:
                yield
            finally:
                self.counts[name] += 1
                if nvtx:
                    torch.cuda.nvtx.range_pop()

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, n = self.totals[name], self.counts[name]
            lines.append(f"{name:24s} {t*1000:10.2f} ms total "
                         f"{t/n*1000:8.3f} ms/call x{n}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir, device=None):
    """torch.profiler over the block, CPU activities and, on a CUDA
    device ("cuda" by default; raises without a card), CUDA activities;
    yields the profiler (key_averages() for device time by kernel) and
    writes logdir/trace.json, a Chrome trace (chrome://tracing, Perfetto),
    unless logdir is None."""
    from torch.profiler import ProfilerActivity, profile
    dev = resolve_device(device)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    if logdir is not None:
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def host_waits(device):
    """Counts the calls in the block that make the host wait for the
    card (a fetch, .item(), bool() of a tensor; torch.cuda's sync debug
    mode): yields a Counter of (file, line) -> calls, filled when the
    block ends. On the CPU there is nothing to wait for: it stays empty.
    Not thread-safe (it records Python warnings)."""
    sites = Counter()
    if torch.device(device).type != "cuda":
        yield sites
        return
    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield sites
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    for w in caught:
        if is_wait(str(w.message)):
            sites[(_site(w.filename), w.lineno)] += 1


def is_wait(message: str) -> bool:
    """A warning of the sync debug mode that reports a wait: not the
    mode's own notice, printed once a process ("Synchronization debug mode
    is a prototype feature and does not yet detect all synchronizing
    operations")."""
    return "synchroniz" in message and "prototype feature" not in message


def _site(path):
    """A wait's file: relative to the working directory, or from the
    package name on for an installed package's file (torch/...)."""
    rel = os.path.relpath(path)
    return rel.split("site-packages" + os.sep)[-1] if rel.startswith("..") \
        else rel
