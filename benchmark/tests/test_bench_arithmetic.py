"""The metric arithmetic: the union of busy intervals, kernel time, the
intra transform units counted through the frozen parse and the work of
kernel 6 over them."""

from __future__ import annotations

from collections import Counter

import pytest

from benchmark import trace as T
from benchmark import work
from benchmark.reference.decode import syntax_counts
from benchmark.tests.rehearsal import REPO


def _trace(device, window=(0, 100), host=(), frames=4, extra=None):
    return T.Trace(list(device), list(host), window, frames, extra)


def test_idle_share_counts_overlapping_lanes_once():
    # two streams busy over [10, 40) and [30, 60): 50 of 100 ns busy
    tr = _trace([("k", 10, 40), ("k", 30, 60), ("m", 80, 90)])
    assert tr.busy_s() == pytest.approx(60e-9)
    assert tr.idle_share() == pytest.approx(0.4)
    # the sum over lanes would count the overlap twice (70 ns)
    assert sum(b - a for _, a, b in tr.device) == 70


def test_idle_share_none_without_device_work():
    assert _trace([]).idle_share() is None


def test_breakdown_names_gaps_by_the_innermost_host_event():
    host = [("outer", 0, 100, 1), ("inner", 40, 70, 1)]
    tr = _trace([("k", 0, 40), ("k", 70, 100)], host=host)
    b = tr.breakdown()
    assert b["device_ops"] == [["k", pytest.approx(70e-9)]]
    assert b["idle_gaps"] == [["inner", pytest.approx(30e-9)]]


def test_kernel_time():
    tr = _trace([("enc_intra_scan_kernel", 0, 10), ("mc_kernel", 5, 8)])
    assert tr.kernel_s(lambda n: "enc_intra_scan" in n) == \
        pytest.approx(1e-8)


def test_merged_intervals():
    assert T.merged([(5, 6), (1, 3), (2, 4)]) == [(1, 4), (5, 6)]
    assert T.union_ns([(0, 10), (0, 10)]) == 10


def _intra(stream):
    c = Counter()
    for f in syntax_counts(REPO / "testdata" / stream):
        c.update(f["intra"])
    return c


def test_intra_work_counted_from_the_syntax():
    c = _intra("intra_only.bit")
    # 3 CIF frames, every block intra: the TUs cover every sample
    per_class = Counter()
    for (cls, s, _), n in c.items():
        per_class[cls] += n * s * s
    assert per_class["Y"] == 3 * 352 * 288
    assert per_class["UV"] == 3 * 2 * 176 * 144
    nbytes, ops = work.encode_scan_work(c)
    assert nbytes == sum(n * (10 * s * s + 4 * (2 * s + 1))
                         for (_, s, _), n in c.items())
    assert sum(c.values()) > 0 and work.bound_kind(nbytes, ops) == "bytes"


def test_encode_scan_work_counts_inverse_stages_only_where_coded():
    coded = Counter({("Y", 8, True): 1})
    zero = Counter({("Y", 8, False): 1})
    b1, o1 = work.encode_scan_work(coded)
    b0, o0 = work.encode_scan_work(zero)
    assert b1 == b0 == 10 * 64 + 4 * 17
    assert o1 == 2 * o0 == 2 * 2 * (8 * 64 + 64 * 8)
    # a 64x64 unit: the 32-point transforms on 16 kept rows
    b, o = work.encode_scan_work(Counter({("Y", 64, True): 1}))
    assert o == 2 * (16 * 32 * 32 + 16 * 16 * 32) * 2


def test_roofline_reader_none_without_kernel_time():
    from benchmark.metrics._common import roofline
    tr = _trace([("mc_kernel", 0, 10)])
    assert roofline(tr, lambda n: "intra" in n, 100, 0) is None
    tr = _trace([("enc_intra_scan_kernel", 0, 10)])
    assert roofline(tr, lambda n: "intra" in n, 3350, 0) == pytest.approx(
        100.0 * (3350 / work.HBM_BYTES_PER_S) / 1e-8)
