"""The sharded decoder and encoder on CUDA graphs, one lane per slot
(thor_tpu_torch/parallel/fused.py, the lanes of ops/graphs.py), on CPU
slots, where each entry runs its program on its buffers through the
kernels' plain versions (the graph is captured only on a card), and,
marked gpu, on streams of the card:

  - sharded_reconstruct(fused=True) against fused=False and
    dec/reconstruct.reconstruct_frame, frame for frame, at every mesh;
  - ShardedDecoder(fused=True) on the CIF goldens (*_dec.yuv) at 2x2,
    4x1 and 1x4, RA16_long at 4x2 (its sha256), the levels against
    thor_tpu's (testdata/torch_levels.json), the CLI's --mesh fused and
    --eager;
  - lanes: two slots' entries and stacks, the band signatures' bound, two
    threads decoding on one lane;
  - ShardedEncoder(fused=True) at 1 and 2 slots against thor_tpu's bytes
    (testdata/torch_enc_*.bit), a slot never given two frames in flight.

Tolerance: equal planes, equal bytes, equal level lists.
"""

import hashlib
import io
import threading
from contextlib import redirect_stdout
from pathlib import Path

import pytest
import torch

from thor_tpu_torch.dec import fused as DF
from thor_tpu_torch.dec.__main__ import main as dec_main
from thor_tpu_torch.dec.decoder import decode_file
from thor_tpu_torch.enc.encoder import Encoder, EncoderParams
from thor_tpu_torch.ops import enc_intra as EI
from thor_tpu_torch.ops import graphs as G
from thor_tpu_torch.ops import interp as TI
from thor_tpu_torch.ops import intra as IT
from thor_tpu_torch.ops import mc as MC
from thor_tpu_torch.parallel import fused as PF
from thor_tpu_torch.parallel.encode import ShardedEncoder
from thor_tpu_torch.parallel.mesh import (Made, make_decode_mesh,
                                          sharded_reconstruct)
from thor_tpu_torch.parallel.stream import ShardedDecoder

from tools.gen_torch_enc_goldens import golden_path, load_frames
from tools.gen_torch_levels import CIF_STREAMS, load_levels

from .test_torch_parallel import MESHES, _real_frames

TESTDATA = Path(__file__).resolve().parent.parent / "testdata"
CPU = torch.device("cpu")
LEVELS = load_levels()
PLAINS = (MC.mc_frame_plain, IT.intra_scan_plain, EI.encode_scan_plain,
          TI.me_level_plain, TI.mot_comp_plain, TI.mot_comp_uv_plain)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def real_frames():
    # an all-intra stream; I and P frames with deblocking and CLPF; RA
    # frames on interpolated references
    return {name: _real_frames(name, n) for name, n in (
        ("intra_only", 2), ("LDB_low_complexity", 4),
        ("RA_low_complexity", 4))}


def _golden(name):
    return (TESTDATA / f"{name}_dec.yuv").read_bytes()


def _bytes(frames):
    return b"".join(p.tobytes() for f in frames for p in f)


def _plain_calls():
    return [f.calls for f in PLAINS]


def _lane_keys(mesh):
    """The lane keys of a CPU mesh's slots."""
    return {("cpu", s.tag) for row in mesh.slots for s in row}


def _entries(kind=object, keys=None):
    return [(ln, sig, e) for (ln, sig), e in list(G.CACHE.entries.items())
            if isinstance(e, kind) and (keys is None or ln.key in keys)]


# ---------------------------------------------------------------------------
# sharded_reconstruct on the slots' lanes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gop,tile", MESHES)
def test_fused_sharded_reconstruct_equals_eager(real_frames, gop, tile):
    mesh = make_decode_mesh(["cpu"], gop=gop, tile=tile)
    for name, (seq, frames) in real_frames.items():
        work = [(c, i, r) for c, i, r, _ in frames]
        fused = sharded_reconstruct(mesh, work, seq.bipred)
        eager = sharded_reconstruct(mesh, work, seq.bipred, fused=False)
        for j, ((fp, fq), (ep, eq)) in enumerate(zip(fused, eager)):
            assert fp.slot is mesh.slots[mesh.row_of(j)][0]
            for a, b, c in zip(fp.tensors + fq.tensors,
                               ep.tensors + eq.tensors, frames[j][3]):
                assert torch.equal(a, b) and torch.equal(a, c), (name, j)
    # every program ran on the lanes of this mesh's slots
    kinds = {type(e) for _, _, e in _entries(keys=_lane_keys(mesh))}
    assert kinds == ({DF._Entry} if tile == 1 else
                     {PF.BandEntry, PF.IntraEntry, PF.FilterEntry})


# ---------------------------------------------------------------------------
# ShardedDecoder(fused=True)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gop,tile", [(2, 2), (4, 1), (1, 4)])
@pytest.mark.parametrize("name", CIF_STREAMS)
def test_fused_sharded_decode_equals_golden(name, gop, tile):
    sd = ShardedDecoder(gop=gop, tile=tile, devices=["cpu"])
    assert sd.fused
    frames = sd.decode_stream(str(TESTDATA / f"{name}.bit"))
    assert _bytes(frames) == _golden(name)
    assert sd.last_level_sizes == LEVELS[name]
    assert sd.mc_clamped == 0
    assert _entries(keys=_lane_keys(sd.mesh))


def test_fused_sharded_decode_ra16_long():
    """The 33-frame RA16 stream over 4 gop rows of 2 tile slots, its
    interpolated references on the frames' tile-0 lanes."""
    sd = ShardedDecoder(gop=4, tile=2, devices=["cpu"])
    h = hashlib.sha256()
    for planes in sd.iter_frames(str(TESTDATA / "RA16_long.bit")):
        for p in planes:
            h.update(p.tobytes())
    want = (TESTDATA / "RA16_long_dec.sha256").read_text().split()[0]
    assert h.hexdigest() == want
    assert sd.last_level_sizes == LEVELS["RA16_long"]
    tile0 = {("cpu", row[0].tag) for row in sd.mesh.slots}
    from thor_tpu_torch.ops.interp_fused import InterpEntry
    interp = {ln.key for ln, _, _ in _entries(InterpEntry,
                                              _lane_keys(sd.mesh))}
    assert interp and interp <= tile0


@pytest.mark.parametrize("eager", [False, True])
def test_cli_mesh_fused_and_eager(tmp_path, eager):
    """python -m thor_tpu_torch.dec ... --mesh 2x2 [--eager]: the
    golden's bytes either way; only the fused run adds entries."""
    G.CACHE.clear()
    out = tmp_path / "o.yuv"
    with redirect_stdout(io.StringIO()):
        rc = dec_main([str(TESTDATA / "LDB_low_complexity.bit"), str(out),
                       "--device", "cpu", "--mesh", "2x2"]
                      + (["--eager"] if eager else []))
    assert rc == 0 and out.read_bytes() == _golden("LDB_low_complexity")
    assert bool(G.CACHE.entries) != eager


# ---------------------------------------------------------------------------
# lanes
# ---------------------------------------------------------------------------

def test_two_slots_get_their_own_lanes(real_frames):
    """One frame on both gop rows of a 2x1 mesh: one signature, two
    lanes, two entries with stacks of their own; the default lane (no
    slot) is a third."""
    seq, frames = real_frames["LDB_low_complexity"]
    mesh = make_decode_mesh(["cpu"], gop=2, tile=1)
    fr = frames[1][:3]
    got = sharded_reconstruct(mesh, [fr, fr], seq.bipred)
    assert torch.equal(got[0][0].tensors[0], got[1][0].tensors[0])
    found = _entries(DF._Entry, _lane_keys(mesh))
    assert len(found) == 2 and found[0][1] == found[1][1]
    (la, _, a), (lb, _, b) = found
    assert la is not lb and a is not b
    assert {la.key, lb.key} == _lane_keys(mesh)
    assert a.stacks[0].data_ptr() != b.stacks[0].data_ptr()
    assert G.lane(CPU).key == ("cpu", None)
    for row in mesh.slots:
        with row[0].active():
            assert G.lane(CPU).key == ("cpu", row[0].tag)


# The band signatures a band slot holds for LDB_medium_complexity's 10
# frames at 1x2 (6 and 8 here): no more than the Decoder's frame
# signatures for the stream (9), since a band's buckets are the frame's or
# smaller
BAND_SIGS = 9


def test_band_signatures_stay_few():
    """LDB_medium_complexity at 1x2: each band slot holds at most
    BAND_SIGS band signatures, tile 0 at most 3 intra signatures (one a
    record bucket), each slot one filter signature."""
    sd = ShardedDecoder(gop=1, tile=2, devices=["cpu"])
    assert _bytes(sd.decode_stream(
        str(TESTDATA / "LDB_medium_complexity.bit"))) \
        == _golden("LDB_medium_complexity")
    keys = _lane_keys(sd.mesh)
    band = [ln.key for ln, _, _ in _entries(PF.BandEntry, keys)]
    assert sorted(set(band)) == sorted(keys)
    assert all(1 <= band.count(k) <= BAND_SIGS for k in keys)
    intra = [ln.key for ln, _, _ in _entries(PF.IntraEntry, keys)]
    assert set(intra) == {("cpu", sd.mesh.slots[0][0].tag)}
    assert len(intra) <= 3
    filt = [ln.key for ln, _, _ in _entries(PF.FilterEntry, keys)]
    assert sorted(filt) == sorted(keys)


def test_two_threads_on_one_lane():
    """Two Decoders in two threads on the CPU's one lane, decoding two
    streams whose frames share their signatures (so their entries and
    stacks): both equal their goldens. The lane's lock keeps each frame's
    load, program and clone whole."""
    names = ("LDB_medium_complexity", "HDB16_medium_complexity")
    G.CACHE.clear()
    got, errors = {}, []

    def run(name):
        try:
            got[name] = _bytes(decode_file(str(TESTDATA / f"{name}.bit"),
                                           device="cpu"))
        except BaseException as e:      # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=run, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert all(got[n] == _golden(n) for n in names)
    # one lane, and fewer entries than frames: the streams shared them
    lanes = {ln.key for ln, _, _ in _entries(DF._Entry)}
    assert lanes == {("cpu", None)}
    assert len(_entries(DF._Entry)) == 9


# ---------------------------------------------------------------------------
# ShardedEncoder(fused=True)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slots", [1, 2])
@pytest.mark.parametrize("name", ["ldb_qcif", "ra_qcif"])
def test_fused_sharded_encode_writes_thor_tpu_bytes(name, slots, tmp_path,
                                                    monkeypatch):
    """The committed thor_tpu streams byte for byte; each clone's frame
    on its slot's lane, and no slot given a second frame while one is in
    flight (a frame is in flight from its _begin to its
    encode_frame_finish)."""
    fields, frames = load_frames(name)
    se = ShardedEncoder(EncoderParams(**fields), devices=["cpu"] * slots)
    assert se.fused and se.enc.fused
    inflight = {}
    begin, finish = se._begin, Encoder.encode_frame_finish

    def watched_begin(fe, pend, slot, w):
        assert id(slot) not in inflight.values()
        inflight[id(fe)] = id(slot)
        return begin(fe, pend, slot, w)

    def watched_finish(self, w, ctx=None):
        inflight.pop(id(self), None)
        return finish(self, w, ctx)

    monkeypatch.setattr(se, "_begin", watched_begin)
    monkeypatch.setattr(Encoder, "encode_frame_finish", watched_finish)
    out = tmp_path / "par.bit"
    se.encode_sequence(frames, str(out))
    assert out.read_bytes() == golden_path(name).read_bytes()
    keys = {("cpu", s.tag) for s in se.slots}
    from thor_tpu_torch.enc.fused import EncEntry
    # a low-delay chain keeps one slot; the RA form's B levels take both
    used = {ln.key for ln, _, _ in _entries(EncEntry, keys)}
    assert used == keys if name == "ra_qcif" else len(used) == 1


def test_slot_picker_takes_a_free_slot():
    """_free_slot: the first slot with no frame in flight, never the
    busy one that the old rule (slot len(batch) % slots) would take after
    the oldest frame drained; None when every slot is busy."""
    se = ShardedEncoder(EncoderParams(width=64, height=64, device_encode=1),
                        devices=["cpu"] * 3)
    s0, s1, s2 = se.slots
    assert se._free_slot([]) is s0
    # s0's frame drained first; s1 still in flight: the old rule took s1
    assert se._free_slot([(None, None, None, s1)]) is s0
    assert se._free_slot([(None, None, None, s0),
                          (None, None, None, s1)]) is s2
    assert se._free_slot([(None, None, None, s)
                          for s in (s2, s0, s1)]) is None


def _free_elsewhere(lock):
    """True if another thread can take `lock` now."""
    got = []

    def probe():
        got.append(lock.acquire(blocking=False))
        if got[0]:
            lock.release()

    t = threading.Thread(target=probe)
    t.start()
    t.join()
    return got[0]


def test_an_entry_serves_one_frame_at_a_time(tmp_path, monkeypatch):
    """A P/B entry's final reads its measure's outputs in place, so a
    fused frame holds its lane's lock from its measure to its final's
    fetch: another thread cannot take the lane in between, and can once
    the final has fetched, or once the frame failed in between."""
    from thor_tpu_torch.enc import device_inter as DI, fused as FU
    fields, frames = load_frames("ldb_qcif")
    params = dict(fields, num_frames=2)
    finish, seen = FU.finish_frame, []

    def watched(enc, w, ctx, leaves):
        lock = G.lane(ctx["org"][0].device).lock
        seen.append(_free_elsewhere(lock))
        out = finish(enc, w, ctx, leaves)
        seen.append(_free_elsewhere(lock))
        return out

    monkeypatch.setattr(FU, "finish_frame", watched)
    Encoder(EncoderParams(**params), device="cpu").encode_sequence(
        frames[:2], str(tmp_path / "a.bit"))
    assert seen == [False, True]

    def fails(*args, **kwargs):
        raise RuntimeError("the walk failed")

    monkeypatch.setattr(DI, "decide_frame", fails)
    with pytest.raises(RuntimeError, match="the walk failed"):
        Encoder(EncoderParams(**params), device="cpu").encode_sequence(
            frames[:2], str(tmp_path / "b.bit"))
    assert _free_elsewhere(G.lane(CPU).lock)


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
def test_cuda_fused_sharded_reconstruct_equals_eager(card, gop, tile):
    seq, frames = _real_frames("LDB_low_complexity", 4)
    mesh = make_decode_mesh([card], gop=gop, tile=tile)
    slot = mesh.slots[0][0]
    with slot.active():     # the uploads are queued on the slot's stream
        work = [(c, i, [Made(tuple(t.to(card) for t in m.tensors), slot)
                        for m in r]) for c, i, r, _ in frames]
    for _ in range(2):      # the captures, then the replays
        got = sharded_reconstruct(mesh, work, seq.bipred)
        torch.cuda.synchronize()
        for j, (planes, padded) in enumerate(got):
            for a, b in zip(planes.tensors + padded.tensors, frames[j][3]):
                assert torch.equal(a.cpu(), b), j


@pytest.mark.gpu
@pytest.mark.parametrize("gop,tile", [(2, 2), (4, 1), (1, 4)])
@pytest.mark.parametrize("name", CIF_STREAMS)
def test_cuda_fused_sharded_decode_equals_golden(card, name, gop, tile):
    """Slots as streams of the one card, each on its lane's graphs: the
    golden, thor_tpu's levels, no plain version called."""
    c0 = _plain_calls()
    sd = ShardedDecoder(gop=gop, tile=tile)
    frames = sd.decode_stream(str(TESTDATA / f"{name}.bit"))
    assert _bytes(frames) == _golden(name)
    assert sd.last_level_sizes == LEVELS[name]
    assert _plain_calls() == c0


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["ldb_qcif", "ra_qcif"])
def test_cuda_fused_sharded_encode_on_two_streams(card, name, tmp_path):
    c0 = _plain_calls()
    fields, frames = load_frames(name)
    out = tmp_path / "par.bit"
    ShardedEncoder(EncoderParams(**fields), devices=["cuda:0", "cuda:0"]) \
        .encode_sequence(frames, str(out))
    assert out.read_bytes() == golden_path(name).read_bytes()
    assert _plain_calls() == c0


def _in_threads(jobs):
    """Run each job in a thread of its own, all at once: their results."""
    out, errors = [None] * len(jobs), []
    start = threading.Barrier(len(jobs))

    def run(k):
        try:
            start.wait()
            out[k] = jobs[k]()
        except BaseException as e:      # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=run, args=(k,))
               for k in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


@pytest.mark.gpu
def test_cuda_two_decoders_in_two_threads(card):
    """Two Decoders on the card's default stream (one lane) in two
    threads, twice (cold, then on captured graphs): both goldens."""
    names = ("LDB_medium_complexity", "RA_low_complexity")
    for _ in range(2):
        got = _in_threads([
            lambda n=n: _bytes(decode_file(str(TESTDATA / f"{n}.bit")))
            for n in names])
        assert [g == _golden(n) for g, n in zip(got, names)] == [True] * 2


@pytest.mark.gpu
def test_cuda_decoder_and_encoder_in_two_threads(card, tmp_path):
    """A Decoder and an Encoder in two threads on one card: the golden
    and thor_tpu's bytes."""
    fields, frames = load_frames("ra_qcif")
    out = tmp_path / "e.bit"
    got = _in_threads([
        lambda: _bytes(decode_file(str(TESTDATA
                                       / "LDB_medium_complexity.bit"))),
        lambda: Encoder(EncoderParams(**fields)).encode_sequence(
            frames, str(out))])
    assert got[0] == _golden("LDB_medium_complexity")
    assert out.read_bytes() == golden_path("ra_qcif").read_bytes()


@pytest.mark.gpu
@pytest.mark.parametrize("name,gop,tile", [("RA_low_complexity", 2, 2),
                                           ("RA16_long", 4, 2)])
def test_cuda_fused_sharded_decode_across_cards(card, name, gop, tile):
    """Slots on every visible card (round-robin), each on its card's lane:
    references and bands cross cards by copies after the producer's
    event. Needs two cards or more."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices or more")
    sd = ShardedDecoder(gop=gop, tile=tile)
    assert len({s.device for row in sd.mesh.slots for s in row}) > 1
    h = hashlib.sha256()
    for planes in sd.iter_frames(str(TESTDATA / f"{name}.bit")):
        for p in planes:
            h.update(p.tobytes())
    gold = TESTDATA / f"{name}_dec.yuv"
    want = hashlib.sha256(gold.read_bytes()).hexdigest() if gold.exists() \
        else (TESTDATA / f"{name}_dec.sha256").read_text().split()[0]
    assert h.hexdigest() == want
    assert sd.last_level_sizes == LEVELS[name]


@pytest.mark.gpu
def test_cuda_fused_sharded_encode_across_cards(card, tmp_path):
    """One slot on each visible card, each clone on its card's lane.
    Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices or more")
    fields, frames = load_frames("ra_qcif")
    out = tmp_path / "par.bit"
    ShardedEncoder(EncoderParams(**fields)).encode_sequence(frames, str(out))
    assert out.read_bytes() == golden_path("ra_qcif").read_bytes()
