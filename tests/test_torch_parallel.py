"""The port's parallel decode paths (thor_tpu_torch/parallel) on CPU slots
(the kernels' plain versions), and, marked gpu, on streams of the card:
the eager stages (fused=False); the default, CUDA graphs on the slots'
lanes, is held to the same goldens in tests/test_torch_parallel_fused.py.

- sharded_reconstruct against dec/reconstruct.reconstruct_frame, frame
  for frame on real inputs of three goldens, at every tested mesh shape;
- ShardedDecoder on the CIF goldens against *_dec.yuv, RA16_long against
  its sha256, its dependency levels against thor_tpu's
  (testdata/torch_levels.json, written by tools/gen_torch_levels.py; the
  live comparison is marked slow);
- the CLI's --mesh, the knobs, and what the port refuses.
Tolerance: equal planes, equal bytes, equal level lists.
"""

import hashlib
import io
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from thor_tpu_torch import native
from thor_tpu_torch.bitstream.reader import BitReader, iter_frames
from thor_tpu_torch.codec.constants import MAX_REF_FRAMES
from thor_tpu_torch.dec.__main__ import main as dec_main
from thor_tpu_torch.dec.decoder import Decoder, RefFrame, needs_interp
from thor_tpu_torch.dec.inputs import build_frame_inputs
from thor_tpu_torch.dec.parse import SequenceHeader
from thor_tpu_torch.dec.reconstruct import (band_inputs, band_rows, mc_luts,
                                            reconstruct_frame, to_device)
from thor_tpu_torch.device import check_current
from thor_tpu_torch.native import parse_frame, seqhdr_from_python
from thor_tpu_torch.ops import interp as TI
from thor_tpu_torch.ops import intra as IT
from thor_tpu_torch.ops import mc as MC
from thor_tpu_torch.parallel.mesh import (Made, Slot, make_decode_mesh,
                                          sharded_reconstruct)
from thor_tpu_torch.parallel.stream import ShardedDecoder

from tools.gen_torch_levels import CIF_STREAMS, load_levels

TESTDATA = Path(__file__).resolve().parent.parent / "testdata"

CPU = torch.device("cpu")
MESHES = [(1, 1), (1, 2), (1, 4), (1, 8), (2, 1), (2, 2), (4, 1)]
LEVELS = load_levels()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _golden(name):
    return (TESTDATA / f"{name}_dec.yuv").read_bytes()


def _bytes(frames):
    return b"".join(p.tobytes() for f in frames for p in f)


def _counts():
    plains = (MC.mc_frame_plain, IT.intra_scan_plain, TI.me_level_plain,
              TI.mot_comp_plain, TI.mot_comp_uv_plain)
    return {f.__name__: f.calls for f in plains}


def _delta(c0):
    return {k: v - c0[k] for k, v in _counts().items()}


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def test_make_decode_mesh_shapes_and_default_split():
    """thor_tpu's default split (gop 2 when the count is even and above 1,
    the rest on tile); more slots than devices share them round-robin;
    CPU slots have no stream."""
    for n, shape in ((1, (1, 1)), (2, (2, 1)), (3, (1, 3)), (8, (2, 4))):
        mesh = make_decode_mesh(["cpu"] * n)
        assert mesh.shape == shape
        assert mesh.rows == list(range(shape[0]))
    mesh = make_decode_mesh(["cpu"], gop=4, tile=2)
    assert mesh.shape == (4, 2)
    assert [mesh.row_of(j) for j in range(6)] == [0, 1, 2, 3, 0, 1]
    assert all(s.device == CPU and s.stream is None
               for row in mesh.slots for s in row)
    assert make_decode_mesh(["cpu"], gop=3).shape == (3, 1)


def test_no_card_raises():
    """devices=None means every visible card: without one it raises, and
    nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_decode_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedDecoder(gop=2, tile=2)


def test_band_rows():
    """Band edges on multiples of 64 luma rows, as even as the superblock
    rows allow; a band may be empty (1x8 on CIF's 4.5 superblock rows)."""
    assert band_rows(288, 1) == [(0, 288)]
    assert band_rows(288, 2) == [(0, 128), (128, 288)]
    assert band_rows(1080, 4) == [(0, 256), (256, 512), (512, 768),
                                  (768, 1080)]
    b8 = band_rows(288, 8)
    assert len(b8) == 8 and b8[0] == (0, 0) and b8[-1] == (256, 288)
    assert sum(r1 - r0 for r0, r1 in b8) == 288
    assert all(r0 % 64 == 0 for r0, _ in b8)


def test_band_inputs_refuse_a_record_across_a_superblock_row():
    rec = np.zeros((1, MC.NF), np.int32)
    rec[0, MC.R_Y0], rec[0, MC.R_H] = 56, 16
    with pytest.raises(ValueError, match="crosses a 64-row line"):
        band_inputs({"mc_y": rec}, 0, 64)


def test_wrapper_device_check(monkeypatch):
    """A kernel wrapper refuses tensors of another card than the current
    one (the ctypes kernels launch on the current device)."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    with pytest.raises(ValueError, match="current CUDA device is cuda:1"):
        check_current("mc_frame", torch.device("cuda", 0))
    check_current("mc_frame", torch.device("cuda", 1))


def test_made_on_cpu_slots():
    """CPU slots run in order: a reader takes the producer's tensors."""
    t = (torch.arange(4),)
    m = Made(t, Slot(CPU))
    assert m.event is None and m.on(Slot(CPU))[0] is t[0]


# ---------------------------------------------------------------------------
# sharded_reconstruct against reconstruct_frame
# ---------------------------------------------------------------------------

def _real_frames(name, n):
    """The first n frames of a golden in decode order: (seq, [(cfg, host
    inputs, refs as Made, (planes, padded) of reconstruct_frame)])."""
    payloads = list(iter_frames(str(TESTDATA / f"{name}.bit")))[:n]
    br = BitReader(payloads[0])
    seq = SequenceHeader.read(br)
    dec = Decoder(device="cpu")
    dec.start(seq)
    cs = seqhdr_from_python(seq)
    luts = mc_luts(seq.bipred, CPU)
    slot = Slot(CPU)
    nums, pos, out = [0] * MAX_REF_FRAMES, br.pos, []
    for p in payloads:
        nf = parse_frame(p, pos, cs, nums)
        pos = 0
        if needs_interp(nf.hdr):
            dec._make_interp_frame(nf.hdr)
        cfg, inp, slots = build_frame_inputs(nf, seq, nums)
        refs = [dec.refs[r] if r >= 0 else dec.interp_frame for r in slots]
        planes, padded = reconstruct_frame(cfg, to_device(inp, CPU), refs,
                                           luts)
        out.append((cfg, inp, [Made((r.y, r.u, r.v), slot) for r in refs],
                    planes + padded))
        dfn = nf.hdr.display_frame_num
        dec.refs = [RefFrame(*padded, dfn)] + dec.refs[:-1]
        nums = [dfn] + nums[:-1]
    return seq, out


@pytest.fixture(scope="module")
def real_frames():
    # an all-intra stream; I and P frames with deblocking and CLPF; RA
    # frames on interpolated references
    return {name: _real_frames(name, n) for name, n in (
        ("intra_only", 2), ("LDB_low_complexity", 4),
        ("RA_low_complexity", 4))}


@pytest.mark.parametrize("gop,tile", MESHES)
def test_sharded_reconstruct_equals_reconstruct_frame(real_frames, gop,
                                                      tile):
    mesh = make_decode_mesh(["cpu"], gop=gop, tile=tile)
    for name, (seq, frames) in real_frames.items():
        got = sharded_reconstruct(
            mesh, [(c, i, r) for c, i, r, _ in frames], seq.bipred,
            fused=False)
        for j, (planes, padded) in enumerate(got):
            assert planes.slot is mesh.slots[mesh.row_of(j)][0]
            for a, b in zip(planes.tensors + padded.tensors, frames[j][3]):
                assert torch.equal(a, b), (name, j)


def test_sharded_reconstruct_skips_other_processes_frames(real_frames):
    seq, frames = real_frames["LDB_low_complexity"]
    mesh = make_decode_mesh(["cpu"], gop=2, tile=1)
    got = sharded_reconstruct(mesh, [None, frames[1][:3]], seq.bipred,
                              fused=False)
    assert got[0] is None
    assert torch.equal(got[1][0].tensors[0], frames[1][3][0])


# ---------------------------------------------------------------------------
# ShardedDecoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gop,tile", [(2, 2), (4, 1), (1, 4)])
@pytest.mark.parametrize("name", CIF_STREAMS)
def test_sharded_decode_equals_golden(name, gop, tile):
    sd = ShardedDecoder(gop=gop, tile=tile, devices=["cpu"], fused=False)
    frames = sd.decode_stream(str(TESTDATA / f"{name}.bit"))
    assert _bytes(frames) == _golden(name)
    assert sd.last_level_sizes == LEVELS[name]
    assert sd.mc_clamped == 0


def test_sharded_decode_ra16_long_gop_parallel():
    """The 33-frame RA16 stream: two dyadic sub-GOPs whose B levels reach
    8 frames, over 4 gop rows of 2 tile slots."""
    sd = ShardedDecoder(gop=4, tile=2, devices=["cpu"], fused=False)
    h = hashlib.sha256()
    n = 0
    for planes in sd.iter_frames(str(TESTDATA / "RA16_long.bit")):
        for p in planes:
            h.update(p.tobytes())
        n += 1
    want = (TESTDATA / "RA16_long_dec.sha256").read_text().split()[0]
    assert h.hexdigest() == want
    assert max(sd.last_level_sizes) >= 8
    assert sd.last_level_sizes == LEVELS["RA16_long"]
    assert sum(sd.last_level_sizes) == n == 33


def test_levels_file_invariants():
    """thor_tpu's committed levels: every stream of the generator, each
    summing to its frame count."""
    counts = {n: len(list(iter_frames(str(TESTDATA / f"{n}.bit"))))
              for n in LEVELS}
    assert set(LEVELS) >= set(CIF_STREAMS) | {"RA16_long"}
    assert all(sum(v) == counts[n] for n, v in LEVELS.items())


def test_tile1_runs_the_decoders_calls():
    """A 1x1 mesh runs dec/reconstruct.reconstruct_frame: the same kernel
    calls (here their plain versions) as the Decoder, on an RA stream."""
    path = str(TESTDATA / "RA_low_complexity.bit")
    c0 = _counts()
    a = list(Decoder(device="cpu").decode_stream(path))
    want = _delta(c0)
    c0 = _counts()
    b = ShardedDecoder(gop=1, tile=1, devices=["cpu"],
                       fused=False).decode_stream(path)
    assert _delta(c0) == want
    assert all(want.values())
    assert _bytes(a) == _bytes(b)


def test_level_chunk(monkeypatch):
    """level_chunk bounds a level's width and keeps the decode exact; the
    THOR_LEVEL_CHUNK environment variable is its default."""
    path = str(TESTDATA / "RA_low_complexity.bit")
    sd = ShardedDecoder(gop=2, tile=2, devices=["cpu"], level_chunk=1,
                        fused=False)
    assert _bytes(sd.decode_stream(path)) == _golden("RA_low_complexity")
    assert sd.last_level_sizes == [1] * 10
    monkeypatch.setenv("THOR_LEVEL_CHUNK", "2")
    sd = ShardedDecoder(gop=2, tile=1, devices=["cpu"], fused=False)
    assert _bytes(sd.decode_stream(path)) == _golden("RA_low_complexity")
    assert max(sd.last_level_sizes) == 2
    assert sum(sd.last_level_sizes) == 10


def test_python_parse_route():
    """parse="python" (dec/parse.FrameParser laid out as the C parse's
    frame) decodes to the golden with the same levels."""
    sd = ShardedDecoder(gop=2, tile=2, devices=["cpu"], parse="python",
                        fused=False)
    frames = sd.decode_stream(str(TESTDATA / "RA_low_complexity.bit"))
    assert _bytes(frames) == _golden("RA_low_complexity")
    assert sd.last_level_sizes == LEVELS["RA_low_complexity"]


def test_failed_parser_build_raises(tmp_path, monkeypatch):
    """A C parse that does not build raises; there is no Python
    fallback."""
    bad = tmp_path / "thor_entropy.c"
    bad.write_text("this is not C\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="native build failed"):
        ShardedDecoder(gop=2, tile=1, devices=["cpu"])
    assert ShardedDecoder(devices=["cpu"], parse="python").parse_mode \
        == "python"
    with pytest.raises(ValueError, match="parse must be"):
        ShardedDecoder(devices=["cpu"], parse="jax")


def test_cli_mesh(tmp_path):
    """python -m thor_tpu_torch.dec ... --mesh GxT: the golden's bytes and
    thor_tpu's one line (frames, seconds, fps, mesh, level sizes)."""
    out = tmp_path / "o.yuv"
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = dec_main([str(TESTDATA / "RA_low_complexity.bit"), str(out),
                       "--device", "cpu", "--mesh", "2x2"])
    assert rc == 0
    assert out.read_bytes() == _golden("RA_low_complexity")
    lines = buf.getvalue().splitlines()
    assert len(lines) == 1
    assert lines[0].startswith("decoded 10 frames in ")
    assert lines[0].endswith(
        f"mesh=2x2, gop-level batches={LEVELS['RA_low_complexity']})")


@pytest.mark.slow
@pytest.mark.parametrize("name", list(CIF_STREAMS) + ["RA16_long"])
def test_levels_equal_live_thor_tpu(name):
    """The port's levels against thor_tpu's ShardedDecoder run live (JAX
    on one CPU device; tens of seconds a stream)."""
    import jax
    from thor_tpu.parallel.stream import ShardedDecoder as TpuSharded
    path = str(TESTDATA / f"{name}.bit")
    tpu = TpuSharded(gop=1, tile=1, devices=jax.devices("cpu")[:1])
    tpu.decode_stream(path)
    sd = ShardedDecoder(gop=2, tile=1, devices=["cpu"])
    sd.decode_stream(path)
    assert sd.last_level_sizes == tpu.last_level_sizes


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("gop,tile", MESHES)
def test_cuda_sharded_reconstruct_equals_reconstruct_frame(card, gop, tile):
    seq, frames = _real_frames("LDB_low_complexity", 4)
    mesh = make_decode_mesh([card], gop=gop, tile=tile)
    slot = mesh.slots[0][0]
    with slot.active():     # the uploads are queued on the slot's stream
        work = [(c, i, [Made(tuple(t.to(card) for t in m.tensors), slot)
                        for m in r]) for c, i, r, _ in frames]
    got = sharded_reconstruct(mesh, work, seq.bipred, fused=False)
    torch.cuda.synchronize()
    for j, (planes, padded) in enumerate(got):
        for a, b in zip(planes.tensors + padded.tensors, frames[j][3]):
            assert torch.equal(a.cpu(), b), j


@pytest.mark.gpu
@pytest.mark.parametrize("gop,tile", [(2, 2), (4, 1), (1, 4)])
@pytest.mark.parametrize("name", CIF_STREAMS)
def test_cuda_sharded_decode_equals_golden(card, name, gop, tile):
    """Slots as streams of the one card: the golden, thor_tpu's levels,
    the kernels alone (no plain version called)."""
    c0 = _counts()
    sd = ShardedDecoder(gop=gop, tile=tile, fused=False)
    frames = sd.decode_stream(str(TESTDATA / f"{name}.bit"))
    assert _bytes(frames) == _golden(name)
    assert sd.last_level_sizes == LEVELS[name]
    assert not any(_delta(c0).values())


@pytest.mark.gpu
def test_cuda_sharded_decode_ra16_long(card, tmp_path):
    """RA16_long at 4x2 (8 streams on one card) through the CLI, eager."""
    out = tmp_path / "o.yuv"
    with redirect_stdout(io.StringIO()):
        assert dec_main([str(TESTDATA / "RA16_long.bit"), str(out),
                         "--mesh", "4x2", "--eager"]) == 0
    want = (TESTDATA / "RA16_long_dec.sha256").read_text().split()[0]
    assert hashlib.sha256(out.read_bytes()).hexdigest() == want


@pytest.mark.gpu
@pytest.mark.parametrize("name,gop,tile", [("RA_low_complexity", 2, 2),
                                           ("RA16_long", 4, 2)])
def test_cuda_sharded_decode_across_cards(card, name, gop, tile):
    """Slots on every visible card (round-robin): references and bands
    cross cards by copies after the producer's event. Needs two cards or
    more."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices or more")
    mesh = make_decode_mesh(gop=gop, tile=tile)
    assert len({s.device for row in mesh.slots for s in row}) > 1
    sd = ShardedDecoder(mesh, fused=False)
    h = hashlib.sha256()
    for planes in sd.iter_frames(str(TESTDATA / f"{name}.bit")):
        for p in planes:
            h.update(p.tobytes())
    gold = TESTDATA / f"{name}_dec.yuv"
    want = hashlib.sha256(gold.read_bytes()).hexdigest() if gold.exists() \
        else (TESTDATA / f"{name}_dec.sha256").read_text().split()[0]
    assert h.hexdigest() == want
    assert sd.last_level_sizes == LEVELS[name]
