"""The interpolated reference as one CUDA graph per signature
(thor_tpu_torch/ops/interp_fused.py) on the CPU, where the entry runs its
program on its buffers through the kernels' plain versions (the graph is
captured only on a card):

  - run_interp equals the eager interpolate_frames and thor_tpu's
    device_interp.interpolate_frames_device, the reversed path included;
  - one cache entry per (size, weights), a result that later calls leave
    as it is, a failing program that leaves no entry;
  - Decoder(fused=True) decodes RA16_long to its golden through one entry,
    and a snapshot taken after an interpolated frame restores equal;
  - Decoder(fused=False), ShardedDecoder(fused=False) and
    Encoder(fused=False) add no entry.

Marked gpu: the graph against the eager path on the card, launches
counted through replays, the clone, a capture that fails. Tolerance:
exact equality throughout.
"""

import hashlib

import numpy as np
import pytest
import torch

from thor_tpu_torch.bitstream.reader import BitReader, iter_frames
from thor_tpu_torch.dec.decoder import Decoder, decode_file
from thor_tpu_torch.dec.parse import SequenceHeader
from thor_tpu_torch.enc import encoder as E1
from thor_tpu_torch.ops import graphs as G, interp as TI
from thor_tpu_torch.ops import interp_fused as IF
from thor_tpu_torch.parallel.stream import ShardedDecoder
from thor_tpu_torch.utils.checkpoint import (load_decoder_state,
                                             save_decoder_state)

from .test_torch_interp import DI, _mk_refs

try:
    from .conftest import TESTDATA
except ImportError:
    from pathlib import Path
    TESTDATA = Path(__file__).resolve().parent.parent / "testdata"

CPU = torch.device("cpu")
CASES = [(2, 1), (4, 1), (4, 3), (8, 3), (8, 5)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in parallel processes, and a
    busy CPU makes PyTorch's thread pool many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _refs(seed, w=176, h=144, dev="cpu"):
    r0, r1 = _mk_refs(np.random.default_rng(seed), w, h, (1, 2))
    return r0, r1, r0.to(dev), r1.to(dev)


@pytest.mark.parametrize("ratio,pos", CASES)
def test_run_interp_equals_eager_and_thor_tpu(ratio, pos):
    """176x144 (three levels); (4, 3) and (8, 5) take the reversed path,
    (4, 1), (8, 3) and (8, 5) unequal weights."""
    r0, r1, t0, t1 = _refs(40 + ratio + pos)
    got = IF.run_interp(CPU, t0, t1, ratio, pos)
    eager = TI.interpolate_frames(t0, t1, ratio, pos)
    want = DI.interpolate_frames_device(r0, r1, ratio, pos)
    for name, g, e, wv in zip(("y", "u", "v", "yp", "up", "vp"), got, eager,
                              want):
        assert torch.equal(g, e), name
        assert np.array_equal(g.numpy(), np.asarray(wv)), name
    # the interiors are views of the padded planes, as the eager path's
    assert got[0].data_ptr() == got[3][96:, 96:].data_ptr()


def test_signature_folds_the_reversed_path():
    """(4, 3) is (4, 1) with the references swapped: one signature, and
    the program reads them in the same order."""
    _, _, t0, t1 = _refs(1)
    s1, x1, y1 = IF.signature(t0, t1, 4, 1)
    s3, x3, y3 = IF.signature(t1, t0, 4, 3)
    assert s1 == s3 == IF.InterpSig(176, 144, 3, 1)
    assert x1 is x3 is t0 and y1 is y3 is t1


def test_one_entry_per_weight_pair():
    """(2, 1), (4, 1), (4, 3), (8, 3) and (8, 5): the weights (1, 1),
    (3, 1), (5, 3) give three entries, and a second round adds none."""
    G.CACHE.clear()
    _, _, t0, t1 = _refs(3)
    for _ in range(2):
        for ratio, pos in CASES:
            IF.run_interp(CPU, t0, t1, ratio, pos)
        keys = sorted(k for _, k in G.CACHE.entries)
        assert keys == [("interp", 176, 144, 1, 1),
                        ("interp", 176, 144, 3, 1),
                        ("interp", 176, 144, 5, 3)]
    assert all(isinstance(e, IF.InterpEntry) and e.graph is None
               for e in IF.entries(CPU))
    assert IF.entries(torch.device("meta")) == []


def test_result_outlives_the_next_call():
    """A result is unchanged after a second call of the same signature on
    other references, and differs from that call's."""
    G.CACHE.clear()
    _, _, a0, a1 = _refs(5)
    _, _, b0, b1 = _refs(6)
    first = IF.run_interp(CPU, a0, a1, 2, 1)
    keep = [p.clone() for p in first]
    second = IF.run_interp(CPU, b0, b1, 2, 1)
    assert len(IF.entries(CPU)) == 1
    assert all(torch.equal(p, k) for p, k in zip(first, keep))
    assert not torch.equal(first[3], second[3])


def test_failing_program_raises_and_leaves_no_entry(monkeypatch):
    """A program that fails (on a card: its warm-up or its capture)
    raises out of run_interp and out of a decode; its entry leaves the
    cache, and nothing falls back to the eager path."""
    G.CACHE.clear()
    _, _, t0, t1 = _refs(7)

    def boom(self):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(IF.InterpEntry, "program", boom)
    with pytest.raises(RuntimeError, match="capture failed"):
        IF.run_interp(CPU, t0, t1, 2, 1)
    assert not IF.entries()
    with pytest.raises(RuntimeError, match="capture failed"):
        decode_file(str(TESTDATA / "RA_low_complexity.bit"), device="cpu")
    assert not IF.entries()


def test_fused_decode_of_ra16_long_equals_golden():
    """RA16_long (33 frames; its interpolated references are all at the
    middle of two frames) decodes to its golden through one entry."""
    G.CACHE.clear()
    h = hashlib.sha256()
    n = 0
    for planes in Decoder(device="cpu").decode_stream(
            str(TESTDATA / "RA16_long.bit")):
        for p in planes:
            h.update(p.tobytes())
        n += 1
    want = (TESTDATA / "RA16_long_dec.sha256").read_text().split()[0]
    assert n == 33 and h.hexdigest() == want
    assert [k for _, k in G.CACHE.entries if k[0] == "interp"] == [
        ("interp", 352, 288, 1, 1)]


def _first_part(fused, split=5):
    """RA_low_complexity's first `split` frames (0, 8, 4, 2, 6: frame 2 on
    an interpolated reference) on a Decoder(fused=fused)."""
    payloads = list(iter_frames(str(TESTDATA / "RA_low_complexity.bit")))
    dec = Decoder(device="cpu", fused=fused)
    br = BitReader(payloads[0])
    dec.start(SequenceHeader.read(br))
    out = list(dec.decode_payloads(payloads[:split], br.pos))
    return dec, payloads, out


def test_snapshot_after_an_interpolated_frame_restores_equal(tmp_path):
    """The fused decoder's interpolated reference (a copy of the graph's
    output) equals the eager one; a snapshot taken after it restores in
    a fresh fused decoder, which decodes the rest to the golden."""
    G.CACHE.clear()
    dec, payloads, first = _first_part(True)
    eager, _, first0 = _first_part(False)
    assert dec.interp_frame is not None and IF.entries(CPU)
    for c in "yuv":
        assert torch.equal(getattr(dec.interp_frame, c),
                           getattr(eager.interp_frame, c))
    ckpt = tmp_path / "state.npz"
    save_decoder_state(dec, str(ckpt))
    fresh = load_decoder_state(Decoder(device="cpu"), str(ckpt))
    rest = list(fresh.decode_payloads(payloads[5:]))
    golden = np.fromfile(TESTDATA / "RA_low_complexity_dec.yuv", np.uint8)
    got = np.concatenate([p.ravel() for f in first + rest for p in f])
    assert np.array_equal(got, golden)
    assert all(np.array_equal(a, b) for fa, fb in zip(first, first0)
               for a, b in zip(fa, fb))


def test_eager_and_sharded_decodes_add_no_entry():
    """Decoder(fused=False) and ShardedDecoder(fused=False) synthesize
    the interpolated references stage by stage: no interpolation entry
    (the fused sharded decoder's entries, one set per slot lane, are in
    tests/test_torch_parallel_fused.py)."""
    G.CACHE.clear()
    path = str(TESTDATA / "RA_low_complexity.bit")
    golden = np.fromfile(TESTDATA / "RA_low_complexity_dec.yuv", np.uint8)
    frames = decode_file(path, device="cpu", fused=False)
    assert np.array_equal(np.concatenate([p.ravel() for f in frames
                                          for p in f]), golden)
    assert not IF.entries()
    sd = ShardedDecoder(gop=2, tile=1, devices=["cpu"], fused=False)
    frames = sd.decode_stream(path)
    assert np.array_equal(np.concatenate([p.ravel() for f in frames
                                          for p in f]), golden)
    assert not IF.entries()


@pytest.mark.parametrize("fused", [True, False])
def test_encoder_interp_follows_fused(fused):
    """Encoder._synth_interp: one entry with fused (the default), none
    with fused=False; the same padded planes either way."""
    G.CACHE.clear()
    _, _, t0, t1 = _refs(9)
    enc = E1.Encoder(E1.EncoderParams(width=176, height=144), device="cpu",
                     fused=fused)
    enc.refs = [E1.RefFrame.of_padded(t.y, t.u, t.v, n)
                for n, t in enumerate((t0, t1))] + enc.refs[2:]
    enc.frame_num = 1
    enc._synth_interp(0, 1, 4, 3)
    want = TI.interpolate_frames(t0, t1, 4, 3)
    for c, wv in zip("yuv", want[3:]):
        assert torch.equal(getattr(enc.interp_frame, c), wv)
    assert len(IF.entries()) == int(fused)


# ---------------------------------------------------------------------------
# gpu: the graph on the card
# ---------------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
@pytest.mark.parametrize("ratio,pos", [(2, 1), (4, 3), (16, 7)])
def test_cuda_interp_graph_equals_eager(ratio, pos):
    """352x288 on the card: the graph's planes equal interpolate_frames'
    (the kernels launched stage by stage); the first call captures (its
    warm-up launches for real), each later call replays and counts kernel
    3 four times and kernels 4-5 once; a result outlives the next
    replay."""
    dev = _cuda()
    G.CACHE.clear()
    _, _, a0, a1 = _refs(70 + ratio, 352, 288, dev)
    _, _, b0, b1 = _refs(80 + ratio, 352, 288, dev)
    want = TI.interpolate_frames(a0, a1, ratio, pos)
    c0 = G.STATS["captures"]
    got = IF.run_interp(dev, a0, a1, ratio, pos)
    assert G.STATS["captures"] == c0 + 1
    counters = (TI.me_level, TI.mot_comp, TI.mot_comp_uv)
    n0 = [f.launches for f in counters]
    other = IF.run_interp(dev, b0, b1, ratio, pos)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(counters, n0)] == [4, 1, 1]
    assert G.STATS["captures"] == c0 + 1
    for g, wv in zip(got, want):
        assert torch.equal(g, wv)
    assert torch.equal(other[3], TI.interpolate_frames(b0, b1, ratio,
                                                       pos)[3])


@pytest.mark.gpu
def test_cuda_failing_interp_capture_raises(monkeypatch):
    """A program that waits for the host cannot be captured: run_interp
    raises and leaves no entry."""
    dev = _cuda()
    G.CACHE.clear()
    _, _, a0, a1 = _refs(11, 352, 288, dev)
    real = IF.InterpEntry.program

    def waits(self):
        out = real(self)
        out.sum().item()
        return out

    monkeypatch.setattr(IF.InterpEntry, "program", waits)
    with pytest.raises(RuntimeError):
        IF.run_interp(dev, a0, a1, 2, 1)
    assert not IF.entries()
