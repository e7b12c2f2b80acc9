"""The CPU rehearsal of the encode traffic at QCIF size, the faults the
comparison must catch, and the control, which must come out as not
correct."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest

from benchmark import control, harness
from benchmark.tests.rehearsal import small_root

SEED = 2 ** 31 + 11


def run(root, cell, trace=False, seconds=1.5, seed=SEED):
    return harness.run_cell(cell, seed, seconds, trace, "cpu", time.time(),
                            root, log=lambda *a: None)


@pytest.fixture
def root(tmp_path):
    return small_root(tmp_path)


def test_encode_live_rehearsal(root):
    r = run(root, "qcif.enc", trace=True, seconds=0.5)
    assert r["correct"] is True and r["failed"] == 0
    # the line run.py prints
    assert json.loads(json.dumps(r)) == r
    m = r["metrics"]
    assert m["enc.measure_ms"]["value"] > 0
    assert m["enc.emit_ms"]["value"] > 0
    # one window clip of 3 frames and the same clip again, traced whole
    assert r["checks"]["frames_compared"]["value"] == 6
    assert r["checks"]["header_mismatches"]["value"] == 0
    assert r["checks"]["bytes_excess_pct"]["value"] <= 0
    assert len(r["rd"]) == 2 and r["rd"][0] == r["rd"][1]


def test_the_seed_orders_a_fixed_bank(root):
    """Every seed encodes clips of the same bank: the seed sets their
    order, and a clip reads the same rate and quality in every run."""
    seen = {}
    for seed in (SEED, 3, 4, 5):
        r = run(root, "qcif.enc", seconds=6, seed=seed)
        assert r["correct"] is True
        assert sorted(x["clip"] for x in r["rd"]) == [0, 1]
        for x in r["rd"]:
            assert seen.setdefault(x["clip"], x) == x
        seen.setdefault("orders", set()).add(r["rd"][0]["clip"])
    assert seen["orders"] == {0, 1}


def _patch_encoder(monkeypatch, fault):
    from thor_tpu_torch.enc.encoder import Encoder
    real = Encoder.encode_sequence

    def broken(self, frames, out_path, *a, **kw):
        recon = real(self, frames, out_path, *a, **kw)
        if fault == "unchanged":
            recon[2] = recon[1]                 # the step changes nothing
        elif fault == "half":
            recon = recon[:len(recon) // 2]     # half of the frames dropped
        elif fault == "altered":
            recon[1] = tuple(p.copy() for p in recon[1])
            recon[1][0][3, 5] ^= 1              # one sample altered
        elif fault == "byte":
            data = bytearray(open(out_path, "rb").read())
            data[-3] ^= 0x10                    # one written byte altered
            open(out_path, "wb").write(bytes(data))
        return recon
    monkeypatch.setattr(Encoder, "encode_sequence", broken)


# settings planted in the program where it builds its parameters: the
# in-loop filter off (the sequence header says so), the I frame's QP
# offset gone (the frame headers do), lambdas x8 (worse rate-distortion
# decisions: the PSNR falls by 2 dB and more)
SETTINGS_FAULTS = {
    "deblocking_off": {"deblocking": 0},
    "qp_cascade_off": {"dqpI": 0},
    "lambdas_x8": {"lambda_coeffI": 6.4, "lambda_coeffP": 9.6},
}


def _patch_settings(monkeypatch, fault):
    from thor_tpu_torch.enc.encoder import EncoderParams
    real = EncoderParams.in_code.__func__

    def broken(cls, **fields):
        return real(cls, **dict(fields, **SETTINGS_FAULTS[fault]))
    monkeypatch.setattr(EncoderParams, "in_code", classmethod(broken))


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered", "byte"]
                         + sorted(SETTINGS_FAULTS))
def test_encode_faults_are_not_correct(root, monkeypatch, fault):
    if fault in SETTINGS_FAULTS:
        _patch_settings(monkeypatch, fault)
    else:
        _patch_encoder(monkeypatch, fault)
    r = harness.run_cell("qcif.enc", SEED, 0.1, False, "cpu", time.time(),
                         root, log=lambda *a: None)
    assert r["correct"] is False


def test_control_is_not_correct(root):
    rows = control.readings(root, "qcif.enc", [3, SEED], 2.5, "cpu")
    for row in rows:
        assert row["sound"]["mismatched_samples"] == 0
        assert row["control"]["mismatched_samples"] > 0
        assert row["control_correct"] is False


def test_control_inverse_transform_differs():
    from benchmark.reference import np_kernels as K
    rng = np.random.default_rng(0)
    c = np.zeros((16, 16), np.int16)
    c[:4, :4] = rng.integers(-900, 900, (4, 4))
    exact = K.inverse_transform(c, 16)
    K.LOW_PRECISION[0] = True
    try:
        low = K.inverse_transform(c, 16)
    finally:
        K.LOW_PRECISION[0] = False
    assert np.count_nonzero(exact != low) > 0
    # bfloat16 keeps the range: the error is a rounding, not a wrap
    assert np.abs(exact.astype(int) - low).max() < 16


@pytest.mark.parametrize("fault", control.FAULTS)
def test_planted_faults_run_and_are_taken_back(root, fault):
    """The faults that set the rate and quality numbers' upper readings
    run the cell's traffic, and leave the program as it was."""
    from thor_tpu_torch.enc import device_inter, fused
    before = device_inter.second_chance, fused.second_chance
    rows = control.readings(root, "qcif.enc", [SEED], 0.5, "cpu", fault)
    assert rows[0]["faulted"]["mismatched_samples"] == 0
    assert len(rows[0]["rd"]) == 1
    assert (device_inter.second_chance, fused.second_chance) == before
