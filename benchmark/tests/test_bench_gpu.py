"""The harness on the card at the tests' size (QCIF encode): correct,
with the device readers finding something to read, and the control not
correct. Run on the card with

    python3 -m pytest -q -m gpu benchmark/tests/test_bench_gpu.py
"""

from __future__ import annotations

import time

import pytest

from benchmark import control, harness
from benchmark.tests.rehearsal import small_root

pytestmark = pytest.mark.gpu
SEED = 2 ** 31 + 29


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"


@pytest.fixture
def root(tmp_path):
    return small_root(tmp_path)


def test_encode_on_the_card(root, card):
    t = harness.run_cell("qcif.enc", SEED, 0.5, True, card, time.time(),
                         root, log=lambda *a: None)
    assert t["correct"] is True
    assert t["device"]["platform"] == "gpu"
    assert t["device"]["memory_peak_bytes"] > 0
    m = t["metrics"]
    assert 0 < m["encode_scan_roofline"]["value"] <= 100
    assert 0 < m["device_idle.encode"]["value"] < 100
    assert m["enc.measure_ms"]["value"] > 0
    assert 0 < t["device"]["busy_s"] < t["device"]["window_s"]


def test_control_on_the_card(root, card):
    for row in control.readings(root, "qcif.enc", [SEED], 2.0, card):
        assert row["sound"]["mismatched_samples"] == 0
        assert row["control"]["mismatched_samples"] > 0
