"""Thordec's statistics report: `python -m thor_tpu_torch.dec` prints,
after its timing line, the text of `python -m thor_tpu.dec` (run live
here) and of the committed testdata/torch_dec_stats_<stream>.txt
(tools/gen_torch_dec_stats.py, which the card's machine reads in
chip_smoke.py): every CIF golden on the numpy backend, two of them on the
torch route on the CPU. Tolerance: equal text.
"""

import contextlib
import io
import time

import numpy as np
import pytest
import torch

import thor_tpu.dec.decoder as tpu_decoder
from thor_tpu.dec.__main__ import main as tpu_main
from thor_tpu_torch.dec.__main__ import main, report
from thor_tpu_torch.dec.decoder import Decoder
from tools.gen_torch_dec_stats import (
    CIF_STREAMS, STREAMS, after_timing_line, report_path, thor_tpu_report)

from .conftest import TESTDATA


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in parallel processes, and a
    busy CPU makes PyTorch's thread pool many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cli(name, out, *flags):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main([str(TESTDATA / f"{name}.bit"), str(out), *flags]) == 0
    first, rest = buf.getvalue().split("\n", 1)
    assert first.startswith("decoded ")
    return rest


@pytest.mark.parametrize("name", CIF_STREAMS)
def test_report_numpy_backend(name, tmp_path):
    got = _port_cli(name, tmp_path / "port.yuv", "--backend", "numpy")
    want = thor_tpu_report(name, str(tmp_path / "tpu.yuv"))
    assert got == want
    assert got == report_path(name).read_text()
    assert (tmp_path / "port.yuv").read_bytes() == \
        (TESTDATA / f"{name}_dec.yuv").read_bytes()


@pytest.mark.parametrize("name", ["LDB_medium_complexity",
                                  "HDB16_medium_complexity"])
def test_report_torch_route_on_cpu(name, tmp_path):
    got = _port_cli(name, tmp_path / "port.yuv", "--device", "cpu")
    assert got == report_path(name).read_text()
    assert got == thor_tpu_report(name, str(tmp_path / "tpu.yuv"))
    assert (tmp_path / "port.yuv").read_bytes() == \
        (TESTDATA / f"{name}_dec.yuv").read_bytes()


def test_report_ra16_long_from_stats():
    """RA16_long (33 frames, two GOPs) through a Decoder's stats on the
    numpy backend, against the committed report."""
    dec = Decoder(backend="numpy", collect_stats=True)
    n = sum(1 for _ in dec.decode_stream(str(TESTDATA / "RA16_long.bit")))
    assert n == 33
    assert report(dec.stats) == report_path("RA16_long").read_text()


def test_committed_reports_cover_every_stream():
    for name in STREAMS:
        text = report_path(name).read_text()
        assert text.startswith("\nFrame types:") and "PARAMETER" in text


def test_report_text_equals_thor_tpu_cli_on_synthetic_stats(monkeypatch,
                                                          tmp_path):
    """Keys the goldens leave empty (four references, every bi-ref pair,
    B pictures only) through both report writers."""
    rng = np.random.default_rng(3)
    st = {"frame_type": {"B": 5, "I": 1}, "frame_bits": {"B": 900, "I": 77},
          "cats": {("B", c): int(rng.integers(0, 500)) for c in (
              "frame_header", "super_mode", "mv", "coeff_y", "cbp")},
          "mode": {("B", m): int(rng.integers(1, 99)) for m in range(5)},
          "size": {("B", s): int(rng.integers(1, 99)) for s in (8, 16, 64)},
          "size_mode": {("B", s, m): int(rng.integers(0, 9))
                        for s in (8, 16, 32, 64) for m in range(5)},
          "size_ref": {("B", s, r): int(rng.integers(0, 9))
                       for s in (8, 32) for r in range(4)},
          "bi_ref": {("B", j): int(rng.integers(0, 9)) for j in range(16)},
          "super_stat": {("B", s, c): int(rng.integers(0, 9))
                         for s in (8, 16, 32, 64) for c in range(9)},
          "num_ref_max": 4, "seq_header": 29}

    class _FakeDecoder:
        """thor_tpu's CLI on `st`: one tiny frame, then its report."""

        def __init__(self, *a, **k):
            self.stats = st

        def decode_stream(self, path):
            time.sleep(0.01)
            z = np.zeros((2, 2), np.uint8)
            yield z, z[:1, :1], z[:1, :1]

    monkeypatch.setattr(tpu_decoder, "Decoder", _FakeDecoder)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tpu_main([str(TESTDATA / "intra_only.bit"),
                  str(tmp_path / "out.yuv")])
    assert "bi-ref-B" in report(st) and "INTERr3" in report(st)
    assert report(st) == after_timing_line(buf.getvalue())
