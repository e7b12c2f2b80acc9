"""The span readers' arithmetic (metrics/_spans.py and the readers of the
program's spans and wait counter) on a hand-built trace."""

from __future__ import annotations

import pytest

from benchmark import harness
from benchmark import trace as T
from benchmark.metrics import _spans as S

SPAN_METRICS = ("enc.measure_idle_ms", "enc.decide_idle_ms",
                "enc.second_chance_idle_ms", "enc.final_idle_ms",
                "enc.I_idle_ms", "device_idle.unspanned", "enc.host_waits")

# two lanes overlap over [150, 200): busy [100, 250) [600, 700)
# [1500, 1600); idle [0, 100) [250, 600) [700, 1500) [1600, 2000), 1650 ns
DEVICE = [("k", 100, 200), ("k", 150, 250), ("m", 600, 700),
          ("k", 1500, 1600)]
HOST = [("bench.enc.I.begin", 0, 300), ("enc.frame.I", 0, 300),
        ("enc.search", 20, 120), ("enc.search.fetch", 100, 120),
        ("enc.emit", 250, 290),
        ("enc.frame.P", 300, 1000), ("enc.measure", 300, 650),
        ("enc.measure.fetch", 550, 650), ("enc.decide", 700, 800),
        ("enc.frame.P", 1000, 1800), ("enc.measure", 1000, 1550),
        # a stage that runs twice, its events overlapping: counted once
        ("enc.decide", 1550, 1700), ("enc.decide", 1650, 1750)]
FRAME_TIMES = [{"search": 0.1, "waits": 2}, {"measure": 0.3, "waits": 3},
               {"measure": 0.5, "waits": 3}]


def _trace(host=HOST, frame_times=FRAME_TIMES):
    return T.Trace(DEVICE, [(n, a, b, 1) for n, a, b in host], (0, 2000),
                   3, {"frame_times": frame_times})


def _read(name, tr):
    return harness.metric_reader(name)(tr)


def test_idle_intervals_and_overlap():
    assert S.idle_intervals(_trace()) == [(0, 100), (250, 600), (700, 1500),
                                          (1600, 2000)]
    assert S.overlap_ns([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert S.overlap_ns([(0, 10)], []) == 0


@pytest.mark.parametrize("name,want", [
    # idle under enc.measure: [300, 600) and [1000, 1500), over 2 P frames
    ("enc.measure_idle_ms", (300 + 500) / 2 / 1e6),
    # enc.decide: [700, 800), then the union [1550, 1750) idle from 1600
    ("enc.decide_idle_ms", (100 + 150) / 2 / 1e6),
    # enc.frame.I over [0, 300): idle [0, 100) and [250, 300), 1 I frame
    ("enc.I_idle_ms", 150 / 1e6),
    # no event of the name: nothing to read
    ("enc.second_chance_idle_ms", None),
    ("enc.final_idle_ms", None),
    # idle under no enc.* stage or child span (frame and bench spans do
    # not count): 1650 - (80 + 40 + 300 + 100 + 500 + 150)
    ("device_idle.unspanned", 100 * 480 / 1650),
    ("enc.host_waits", 8 / 3),
])
def test_span_readers_equal_the_hand_count(name, want):
    got = _read(name, _trace())
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_trace_without_the_programs_spans_reads_nothing(name):
    """A program without spans or the counter (the benchmark's own spans
    only): every reader returns None, and none raises."""
    bench = [h for h in HOST if h[0].startswith("bench.")]
    assert _read(name, _trace(bench, [{"measure": 0.3}])) is None
