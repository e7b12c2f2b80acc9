"""The device-only replays on the CPU: the decode replay
(utils/device_decode_fps) re-dispatches every captured frame and must give
the stream's golden planes, interpolated references included; the encode
replay (enc/device_inter.replay_device_frame) runs every recorded P/B
frame's device work again and must give the live encode's
reconstructions. Tolerance: equal planes. On the card the same run is
chip_smoke.py's replay phase."""

import numpy as np
import pytest
import torch

from thor_tpu_torch.enc import encoder as E1
from thor_tpu_torch.enc.device_inter import replay_device_frame
from thor_tpu_torch.ops import interp as TI
from thor_tpu_torch.ops import mc as MC
from thor_tpu_torch.utils import device_decode_fps as DDF
from thor_tpu_torch.utils import device_encode_fps as DEF

from tools.gen_torch_enc_goldens import golden_path, load_frames

from .conftest import TESTDATA


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in parallel processes, and a
    busy CPU makes PyTorch's thread pool many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("stream,interp", [("LDB_low_complexity", 0),
                                           ("RA_low_complexity", 7)])
def test_decode_replay_equals_golden(stream, interp):
    """The replay's planes equal <stream>_dec.yuv (measure raises where
    they differ); the RA stream's 7 interpolated references are made
    again in every repeat."""
    n0 = TI.me_level_plain.calls
    r = DDF.measure(TESTDATA / f"{stream}.bit", reps=1, device="cpu")
    assert r["frames"] == 10 and r["golden"] == "yuv"
    assert r["interp_frames"] == interp
    # capture, the counted repeat and the timed one each synthesize them
    assert bool(TI.me_level_plain.calls - n0) == bool(interp)
    assert r["host_waits_per_frame"] == 0 and len(r["seconds"]) == 1


def test_decode_replay_gate_fails_on_other_planes(tmp_path):
    """A golden the replay does not match stops the run: no number."""
    bit = tmp_path / "LDB_low_complexity.bit"
    bit.write_bytes((TESTDATA / "LDB_low_complexity.bit").read_bytes())
    gold = bytearray((TESTDATA / "LDB_low_complexity_dec.yuv").read_bytes())
    gold[-1] ^= 1
    (tmp_path / "LDB_low_complexity_dec.yuv").write_bytes(bytes(gold))
    with pytest.raises(AssertionError, match="differ from the golden"):
        DDF.measure(bit, reps=1, device="cpu")


_RECORDED = {}


def _recorded(name, tmp_path):
    """(encoder, reconstructions, stream bytes) of a case encoded with
    record=True; each case is encoded once per test process."""
    if name not in _RECORDED:
        fields, frames = load_frames(name)
        out = tmp_path / "o.bit"
        enc = E1.Encoder(E1.EncoderParams(**fields), device="cpu",
                         record=True)
        recons = enc.encode_sequence(frames, str(out))
        _RECORDED[name] = enc, recons, out.read_bytes()
    return _RECORDED[name]


@pytest.mark.parametrize("name", ["ldb_qcif", "ra_qcif"])
def test_encode_replay_equals_live(name, tmp_path):
    """Recording changes nothing in the stream; every replayed P/B frame
    equals the live reconstruction, through the same kernels' plain
    versions (kernel 2 twice a frame); the RA case's interpolated
    references come from the records."""
    enc, recons, data = _recorded(name, tmp_path)
    assert data == golden_path(name).read_bytes()
    recs = enc.device_record
    assert [r["frame_num"] for r in recs] == (
        [1, 2] if name == "ldb_qcif" else [4, 2, 1, 3])
    n0 = MC.mc_frame_plain.calls
    refstate = {}
    for rec in recs:
        y, u, v = replay_device_frame(rec, refstate)
        for got, want in zip((y, u, v), recons[rec["frame_num"]]):
            assert np.array_equal(got.numpy(), want)
    assert MC.mc_frame_plain.calls == n0 + 2 * len(recs)
    # the I frame is uploaded once; on RA each B frame's interpolated
    # reference is its own upload; every other reference is replayed
    ups = [k for r in recs for k in r["uploads"]]
    assert ("r", 0) in ups and len(ups) == len(set(ups))
    assert sum(k[0] == "i" for k in ups) == (3 if name == "ra_qcif" else 0)
    assert set(refstate) == set(ups) | {("r", r["frame_num"]) for r in recs}
    # ldb_qcif's P frames take the second chance (encoder_speed 0): their
    # records carry the extra program's packed variants
    assert all(r["fused"]["extra"] is not None for r in recs) == (
        name == "ldb_qcif")


def test_records_share_no_tensor(tmp_path):
    """A record carries no tensor of another record (no staging cache
    keyed by presence), and the replay tool's gate and count hold."""
    enc, recons, _ = _recorded("ldb_qcif", tmp_path)

    def tensors(x):
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, dict):
            for v in x.values():
                yield from tensors(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                yield from tensors(v)

    owner = {}
    for i, rec in enumerate(enc.device_record):
        for t in tensors(rec):
            if t.numel():
                assert owner.setdefault(t.data_ptr(), i) == i
    r = DEF.replay(enc, recons, reps=1)
    assert r["frames"] == 2 and r["host_waits_per_frame"] == 0
    bad = [tuple(np.zeros_like(p) for p in f) for f in recons]
    with pytest.raises(AssertionError, match="differs from the live"):
        DEF.replay(enc, bad, reps=1)


def test_recording_is_opt_in():
    enc = E1.Encoder(E1.EncoderParams(width=64, height=64, device_encode=1),
                     device="cpu")
    assert enc.device_record is None
