"""thor_tpu_torch.utils.tracing against thor_tpu.utils.tracing: the same
stages under one fake clock give the same report text; device_trace on the
CPU writes a Chrome trace that names a stage; host_waits counts nothing on
the CPU."""

import json
import time

import pytest
import torch

from thor_tpu.utils import tracing as T0

from thor_tpu_torch.utils import tracing as T1
from thor_tpu_torch.utils.profile_decode import host_stages

from .conftest import TESTDATA


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in parallel processes, and a
    busy CPU makes PyTorch's thread pool many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_stage_timer_report_equals_thor_tpus(monkeypatch):
    def run(timer):
        ticks = iter([0.0, 0.25, 1.0, 1.0005, 2.0, 2.5, 3.0, 3.125])
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
        for name in ("parse", "build", "parse", "device_step"):
            with timer.stage(name):
                pass
        return timer.report()

    want = run(T0.StageTimer())
    assert run(T1.StageTimer()) == want
    assert run(T1.StageTimer(device="cpu")) == want
    assert want.splitlines()[0].startswith("parse ")


def test_device_trace_names_a_stage(tmp_path):
    timer = T1.StageTimer(device="cpu")
    with T1.device_trace(str(tmp_path), device="cpu") as prof:
        with timer.stage("thor_stage"):
            torch.ones(64).cumsum(0)
    trace = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "thor_stage" in names
    assert any(e.key == "thor_stage" for e in prof.key_averages())
    with T1.device_trace(None, device="cpu"):
        pass                                    # nothing written
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            with T1.device_trace(str(tmp_path)):
                pass


def test_host_waits_on_the_cpu_counts_nothing():
    with T1.host_waits(torch.device("cpu")) as sites:
        bool(torch.ones(3).sum() > 0)
    assert not sites


def test_host_waits_skip_the_modes_notice():
    """The sync debug mode's one-time notice is not a wait; its reports
    are."""
    assert not T1.is_wait(
        "Synchronization debug mode is a prototype feature and does not "
        "yet detect all synchronizing operations")
    assert T1.is_wait("called a synchronizing CUDA operation")


def test_profile_decode_host_stages_through_the_timer():
    """profile_decode's host stages keep their keys, now from StageTimer,
    with the fused path's packing beside them."""
    r = host_stages(str(TESTDATA / "LDB_low_complexity.bit"))
    assert r["frames"] == 10
    assert set(r) == {"frames", "parse_ms_per_frame", "build_ms_per_frame",
                      "pack_ms_per_frame"}
    assert r["parse_ms_per_frame"] > 0 and r["build_ms_per_frame"] > 0
    assert r["pack_ms_per_frame"] > 0


def test_span_without_a_profiler_opens_no_range(monkeypatch):
    """With no profiler on, span keeps its time and opens no
    record_function (so no profiler event); with one on, each span is an
    event. (StageTimer.stage runs on span: its report is held to
    thor_tpu's above.)"""
    opened = []
    real = torch.profiler.record_function

    def watched(*a, **kw):
        opened.append(a[0])
        return real(*a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", watched)
    times = {"measure": 0.5}
    with T1.span("enc.measure", times, "measure"):
        pass
    with T1.span("enc.measure.fetch"):
        pass
    assert opened == [] and times["measure"] >= 0.5
    with T1.device_trace(None, device="cpu") as prof:
        with T1.span("enc.frame.P", args="3"):
            with T1.span("enc.measure", times, "measure"):
                pass
    assert opened == ["enc.frame.P", "enc.measure"]
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert "enc.frame.P" in names and "enc.measure" in names


def test_waits_are_counted_per_thread():
    import threading
    seen = {}

    def count(k):
        w0 = T1.waits()
        for _ in range(k):
            T1.count_wait()
        seen[k] = T1.waits() - w0

    w0 = T1.waits()
    threads = [threading.Thread(target=count, args=(k,)) for k in (2, 5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    T1.count_wait()
    assert seen == {2: 2, 5: 5} and T1.waits() - w0 == 1
