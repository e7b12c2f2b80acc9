"""Decoder state carried across: a decoder of either package (the port on
either backend) decodes the first frames and saves its state; a fresh
decoder of either package loads it and decodes the rest, which must equal
the straight decode and the golden. Tolerance: exact equality.
"""

import numpy as np
import pytest
import torch

from thor_tpu.bitstream.reader import BitReader as TpuBitReader
from thor_tpu.dec.decoder import Decoder as TpuDecoder
from thor_tpu.dec.parse import SequenceHeader as TpuSequenceHeader
from thor_tpu.dec.reconstruct_np import RefFrame as TpuRefFrame
from thor_tpu.utils.checkpoint import load_decoder_state as \
    tpu_load_decoder_state
from thor_tpu.utils.checkpoint import save_decoder_state
from thor_tpu_torch.bitstream.reader import iter_frames
from thor_tpu_torch.dec.decoder import Decoder
from thor_tpu_torch.utils.checkpoint import load_decoder_state
from thor_tpu_torch.utils.checkpoint import \
    save_decoder_state as save_decoder_state_port

from .conftest import TESTDATA

SPLIT = 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in parallel processes, and a
    busy CPU makes PyTorch's thread pool many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _golden(name, n_frames, W, H):
    g = np.fromfile(TESTDATA / f"{name}_dec.yuv", np.uint8)
    return g.reshape(n_frames, W * H * 3 // 2)


def _tpu_decode(tpu, payloads, first):
    """thor_tpu's numpy decoder over `payloads`; {display number: frame}."""
    out = {}
    for i, p in enumerate(payloads):
        br = TpuBitReader(p)
        if first and i == 0:
            tpu.seq = TpuSequenceHeader.read(br)
            H, W = tpu.seq.height, tpu.seq.width
            tpu.refs = [TpuRefFrame(np.zeros((H, W), np.uint8),
                                    np.zeros((H // 2, W // 2), np.uint8),
                                    np.zeros((H // 2, W // 2), np.uint8), 0)
                        for _ in range(33)]
        y, u, v, dfn = tpu.decode_frame(br)
        out[dfn] = np.concatenate([np.asarray(a).ravel() for a in (y, u, v)])
    return out


def test_port_resumes_from_thor_tpu_checkpoint(tmp_path):
    name = "LDB_medium_complexity"
    payloads = list(iter_frames(str(TESTDATA / f"{name}.bit")))
    tpu = TpuDecoder()
    _tpu_decode(tpu, payloads[:SPLIT], True)
    H, W = tpu.seq.height, tpu.seq.width
    ckpt = tmp_path / "state.npz"
    save_decoder_state(tpu, str(ckpt))

    dec = load_decoder_state(Decoder(device="cpu"), str(ckpt))
    assert dec.next_display == SPLIT
    assert dec.refs[0].y.shape == (H + 192, W + 192)
    out = list(dec.decode_payloads(payloads[SPLIT:]))

    golden = _golden(name, len(payloads), W, H)
    assert len(out) == len(payloads) - SPLIT
    for k, (y, u, v) in enumerate(out):
        got = np.concatenate([y.ravel(), u.ravel(), v.ravel()])
        assert np.array_equal(got, golden[SPLIT + k]), f"frame {SPLIT + k}"


def test_port_resumes_mid_gop_with_interpolated_reference(tmp_path):
    """RA_low_complexity is decoded in the order 0, 8, 4, 2, 6, 1, ...;
    after four frames the snapshot holds an interpolated reference (made
    for frame 2) and three frames decoded ahead of their display turn.
    The port loads it, decodes the rest as thor_tpu does, and puts out
    frames 1..9 in display order, the three carried ones included."""
    name, split = "RA_low_complexity", 4
    payloads = list(iter_frames(str(TESTDATA / f"{name}.bit")))
    tpu = TpuDecoder()
    before = _tpu_decode(tpu, payloads[:split], True)
    assert sorted(before) == [0, 2, 4, 8] and tpu.interp_frame is not None
    ckpt = tmp_path / "state.npz"
    save_decoder_state(tpu, str(ckpt))

    dec = load_decoder_state(Decoder(device="cpu"), str(ckpt))
    assert dec.next_display == 1
    assert sorted(r.frame_num for r in dec.pending) == [2, 4, 8]
    H, W = tpu.seq.height, tpu.seq.width
    assert dec.interp_frame.frame_num == 2
    assert dec.interp_frame.y.shape == (H + 192, W + 192)
    assert np.array_equal(dec.interp_frame.y.numpy(),
                          np.asarray(tpu.interp_frame.y))
    out = list(dec.decode_payloads(payloads[split:]))
    assert dec.next_display == len(payloads) and not dec.pending

    rest = _tpu_decode(tpu, payloads[split:], False)
    golden = _golden(name, len(payloads), W, H)
    assert len(out) == len(payloads) - 1
    for k, (y, u, v) in enumerate(out, start=1):
        got = np.concatenate([y.ravel(), u.ravel(), v.ravel()])
        assert np.array_equal(got, {**before, **rest}[k]), f"frame {k}"
        assert np.array_equal(got, golden[k]), f"frame {k}"


def test_loader_pads_unpadded_planes(tmp_path):
    """A snapshot whose planes are stored unpadded is padded on load."""
    H, W = 16, 24
    rng = np.random.default_rng(0)
    y = rng.integers(0, 256, (H, W), dtype=np.uint8)
    u = rng.integers(0, 256, (H // 2, W // 2), dtype=np.uint8)
    seq = np.array([W, H, 1, 1, 2, 0, 0, 1, 1, 0, 1], np.int64)
    path = tmp_path / "s.npz"
    np.savez(path, seq=seq, ref0_y=y, ref0_u=u, ref0_v=u,
             ref0_num=np.int64(3))
    dec = load_decoder_state(Decoder(device="cpu"), str(path))
    assert np.array_equal(dec.refs[0].y.numpy(), np.pad(y, 96, "edge"))
    assert np.array_equal(dec.refs[0].u.numpy(), np.pad(u, 48, "edge"))
    assert dec.refs[0].frame_num == 3 and dec.next_display == 4
    assert not dec.refs[1].y.any()


def _port_first_part(backend, name, split):
    """The port decodes the first `split` frames of `name`; returns the
    decoder, the payloads and the frames it put out."""
    from thor_tpu_torch.bitstream.reader import BitReader
    from thor_tpu_torch.dec.parse import SequenceHeader
    payloads = list(iter_frames(str(TESTDATA / f"{name}.bit")))
    dec = Decoder(device="cpu", backend=backend)
    br = BitReader(payloads[0])
    dec.start(SequenceHeader.read(br))
    out = list(dec.decode_payloads(payloads[:split], br.pos))
    return dec, payloads, out


def _flat(frames):
    return [np.concatenate([p.ravel() for p in f]) for f in frames]


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_save_and_resume_in_a_fresh_decoder(tmp_path, backend):
    """RA_low_complexity: 5 frames (0, 8, 4, 2, 6: one put out, four
    ahead of their turn, an interpolated reference), a snapshot, the rest
    in a fresh Decoder of the same backend; together they are the straight
    decode and the golden."""
    name = "RA_low_complexity"
    dec, payloads, first = _port_first_part(backend, name, SPLIT)
    assert dec.interp_frame is not None
    ckpt = tmp_path / "state.npz"
    save_decoder_state_port(dec, str(ckpt))

    fresh = load_decoder_state(Decoder(device="cpu", backend=backend),
                               str(ckpt))
    assert fresh.next_display == len(first)
    rest = list(fresh.decode_payloads(payloads[SPLIT:]))
    W, H = dec.seq.width, dec.seq.height
    golden = _golden(name, len(payloads), W, H)
    got = _flat(first + rest)
    assert len(got) == len(payloads)
    for k, f in enumerate(got):
        assert np.array_equal(f, golden[k]), f"frame {k}"


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_thor_tpu_resumes_from_port_snapshot(tmp_path, backend):
    """thor_tpu's load_decoder_state reads the port's file (either
    backend's): the window holds frames 2, 4, 6, 8 decoded ahead of their
    turn, and thor_tpu's numpy decoder decodes 1, 3, 5, 7, 9 from it, all
    equal to the golden."""
    name = "RA_low_complexity"
    dec, payloads, first = _port_first_part(backend, name, SPLIT)
    ckpt = tmp_path / "state.npz"
    save_decoder_state_port(dec, str(ckpt))

    tpu = tpu_load_decoder_state(TpuDecoder(), str(ckpt))
    assert tpu.interp_frame is not None
    H, W = tpu.seq.height, tpu.seq.width
    assert tpu.refs[0].y.shape == (H + 192, W + 192)
    ahead = {r.frame_num: np.concatenate([
        p[n:-n, n:-n].ravel() for p, n in ((r.y, 96), (r.u, 48),
                                           (r.v, 48))])
        for r in tpu.refs[:SPLIT - 1]}
    rest = _tpu_decode(tpu, payloads[SPLIT:], False)
    golden = _golden(name, len(payloads), W, H)
    assert sorted(ahead) == [2, 4, 6, 8] and sorted(rest) == [1, 3, 5, 7, 9]
    for k, f in {**ahead, **rest}.items():
        assert np.array_equal(f, golden[k]), f"frame {k}"


def test_numpy_backend_resumes_from_thor_tpu_checkpoint(tmp_path):
    """thor_tpu's snapshot of RA_low_complexity after four frames (an
    interpolated reference, three frames decoded ahead of their turn) on
    the port's numpy backend: host reference planes, frames 1..9 put out
    in display order, equal to thor_tpu's decode and the golden."""
    name, split = "RA_low_complexity", 4
    payloads = list(iter_frames(str(TESTDATA / f"{name}.bit")))
    tpu = TpuDecoder()
    before = _tpu_decode(tpu, payloads[:split], True)
    ckpt = tmp_path / "state.npz"
    save_decoder_state(tpu, str(ckpt))

    dec = load_decoder_state(Decoder(backend="numpy"), str(ckpt))
    assert dec.next_display == 1 and dec.device is None
    assert isinstance(dec.refs[0].y, np.ndarray)
    assert np.array_equal(dec.interp_frame.y, np.asarray(tpu.interp_frame.y))
    out = list(dec.decode_payloads(payloads[split:]))
    assert dec.next_display == len(payloads) and not dec.pending

    rest = _tpu_decode(tpu, payloads[split:], False)
    golden = _golden(name, len(payloads), tpu.seq.width, tpu.seq.height)
    assert len(out) == len(payloads) - 1
    for k, f in enumerate(_flat(out), start=1):
        assert np.array_equal(f, {**before, **rest}[k]), f"frame {k}"
        assert np.array_equal(f, golden[k]), f"frame {k}"
