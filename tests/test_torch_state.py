"""Decoder state carried across: thor_tpu's numpy Decoder decodes the
first frames and saves its state; the port loads it and decodes the rest,
which must equal the golden. Tolerance: exact equality.
"""

import numpy as np

from thor_tpu.bitstream.reader import BitReader as TpuBitReader
from thor_tpu.dec.decoder import Decoder as TpuDecoder
from thor_tpu.dec.parse import SequenceHeader as TpuSequenceHeader
from thor_tpu.dec.reconstruct_np import RefFrame as TpuRefFrame
from thor_tpu.utils.checkpoint import save_decoder_state
from thor_tpu_torch.bitstream.reader import iter_frames
from thor_tpu_torch.dec.decoder import Decoder
from thor_tpu_torch.utils.checkpoint import load_decoder_state

from .conftest import TESTDATA

SPLIT = 5


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
