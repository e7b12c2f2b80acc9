"""Encoder checkpoints of the port (utils/checkpoint.save_encoder_state /
load_encoder_state, encode_sequence's checkpoint_path / resume_path): an
encode split at a snapshot and resumed by a fresh Encoder writes the
straight encode's bytes, in the port (host mirror and device encoder) and
across the two packages, which share thor_tpu's file format.

The split is LDB (one frame per sub-GOP): a shorter first encode then
meets the same frame types as the straight one. Tolerance: equal bytes,
equal planes.
"""

import numpy as np
import pytest
import torch

from thor_tpu.enc import encoder as E0

from thor_tpu_torch.dec.decoder import decode_file
from thor_tpu_torch.enc import encoder as E1

from tools.gen_torch_enc_goldens import CIF, crop_frames, golden_path, \
    load_frames


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _encoder(E, fields):
    return E.Encoder(E.EncoderParams(**fields)) if E is E0 else \
        E.Encoder(E.EncoderParams(**fields), device="cpu")


def _first_part(E, fields, frames, out, ckpt, k):
    """Encode the first k frames and snapshot after them."""
    return _encoder(E, dict(fields, num_frames=k)).encode_sequence(
        frames, str(out), checkpoint_path=str(ckpt), checkpoint_every=k)


def _resume(E, fields, frames, out, ckpt):
    return _encoder(E, fields).encode_sequence(frames, str(out),
                                               resume_path=str(ckpt))


def _same_frames(a, b):
    return len(a) == len(b) and all(
        np.array_equal(p, q) for fa, fb in zip(a, b) for p, q in zip(fa, fb))


@pytest.mark.parametrize("name", ["host_ldb_qcif", "ldb_qcif"])
def test_split_and_resume_writes_the_golden(name, tmp_path, one_thread):
    """I P | P (two references, bipred): the host mirror and the device
    encoder, each snapshotted after frame 1 and resumed, write their
    committed golden; the two parts' reconstructions are the decode of
    it."""
    fields, frames = load_frames(name)
    out, ckpt = tmp_path / "split.bit", tmp_path / "enc.npz"
    rec_a = _first_part(E1, fields, frames, out, ckpt, 2)
    with np.load(ckpt) as z:
        assert sorted(z.files) == ["loop", "ref0_num", "ref0_u", "ref0_v",
                                   "ref0_y", "ref1_num", "ref1_u", "ref1_v",
                                   "ref1_y"]
        assert z["ref0_y"].shape == (144 + 192, 176 + 192)
        assert z["ref0_u"].dtype == np.uint8 and z["loop"].dtype == np.int64
        assert z["loop"].tolist()[:2] == [2, 2]    # frame_num0, num_encoded
        assert z["loop"][-1] == out.stat().st_size
    rec_b = _resume(E1, fields, frames, out, ckpt)
    assert out.read_bytes() == golden_path(name).read_bytes()
    assert _same_frames(rec_a + rec_b, decode_file(str(out), device="cpu"))


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    """A 64x64 LDB clip (I P P, two references, bipred, tb split) through
    thor_tpu's mirror straight, and each package's snapshot after frame 1
    with the stream up to it."""
    tmp = tmp_path_factory.mktemp("ckpt")
    fields = dict(width=64, height=64, qp=30, num_frames=3, max_num_ref=2,
                  enable_bipred=1, enable_tb_split=1, use_block_contexts=1)
    frames = crop_frames(*CIF, 64, 64, 3)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        straight = tmp / "straight.bit"
        recs = _encoder(E0, fields).encode_sequence(frames, str(straight))
        parts = {}
        for tag, E in (("thor_tpu", E0), ("port", E1)):
            out, ckpt = tmp / f"{tag}.bit", tmp / f"{tag}.npz"
            _first_part(E, fields, frames, out, ckpt, 2)
            parts[tag] = (out.read_bytes(), ckpt)
    finally:
        torch.set_num_threads(n)
    return fields, frames, straight.read_bytes(), recs, parts


def test_snapshots_are_the_same_file(snapshots):
    """Both packages write the same arrays under the same keys at the same
    point, after the same stream prefix."""
    parts = snapshots[4]
    assert parts["thor_tpu"][0] == parts["port"][0]
    with np.load(parts["thor_tpu"][1]) as a, np.load(parts["port"][1]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("first", ["thor_tpu", "port"])
def test_snapshot_resumes_in_the_other_package(snapshots, first, tmp_path,
                                               one_thread):
    """A thor_tpu snapshot resumes in the port, and a port snapshot in
    thor_tpu, to thor_tpu's straight bytes and last reconstruction."""
    fields, frames, straight, recs, parts = snapshots
    out = tmp_path / "resumed.bit"
    out.write_bytes(parts[first][0])
    rec = _resume(E1 if first == "thor_tpu" else E0, fields, frames, out,
                  parts[first][1])
    assert out.read_bytes() == straight
    assert _same_frames(rec, recs[2:])
