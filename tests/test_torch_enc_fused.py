"""The device encoder's fused P/B programs (thor_tpu_torch/enc/fused.py) on
the CPU, and, marked gpu, their kernels on the card.

The oracle is thor_tpu: its committed device-encoder streams
(testdata/torch_enc_ldb_qcif.bit, torch_enc_ra_qcif.bit), its filter
program (_filter_fn) and its zero-run pass (jax_kernels._rdoq_light); the
port's stage-wise path (Encoder(fused=False)) is held to the same bytes.
Every value is an integer: the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

from thor_tpu_torch.codec.constants import (BETA_TABLE, CHROMA_QP, TC_TABLE,
                                            zigzag_for)
from thor_tpu_torch.dec import fused as DF
from thor_tpu_torch.enc import device_inter as DI
from thor_tpu_torch.enc import encoder as E1
from thor_tpu_torch.enc import fused as FU
from thor_tpu_torch.ops import enc_intra as EI, graphs as G
from thor_tpu_torch.ops import intra as IT
from thor_tpu_torch.ops import kernels as K

from tools.gen_torch_enc_goldens import golden_path, load_frames
from tools.trigger_rows import trigger_blocks

try:
    import jax.numpy as jnp
    from thor_tpu.enc.device_inter import _filter_fn
    from thor_tpu.ops import jax_kernels as JK
except ImportError:     # a card's machine without JAX runs the gpu tests
    jnp = _filter_fn = JK = None    # only: pytest --noconftest -m gpu

CASES = ("ldb_qcif", "ra_qcif")
# the signatures each QCIF encode makes: measure programs (entries) and
# final programs (over all entries)
SIGNATURES = {"ldb_qcif": (2, 2), "ra_qcif": (2, 2)}


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


class _Watched(E1.Encoder):
    """An Encoder that keeps, per fused P/B frame, the walk-replayed
    side-info map and patched CLPF masks of its final program beside the
    emit's map (enc.deblock_data when the filters' bits are written)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.maps = []

    def _filters_done(self, w, out):
        dd = self.deblock_data
        emit = K.pack_ddp({k: getattr(dd, k) for k in (
            "size", "tb_split", "pb_part", "mode", "cbp_y", "mv0x", "mv0y",
            "mv1x", "mv1y")})
        self.maps.append((out["ddp"], emit, out["cm"],
                          np.stack(DI.clpf_cand_masks(dd, self.height,
                                                      self.width))))
        super()._filters_done(w, out)


_RUNS = {}


def _encode(name, tmp_path, fused=True, cls=E1.Encoder, **kw):
    """(bytes, reconstructions, encoder) of a case, encoded once per test
    process and variant."""
    key = (name, fused, cls, tuple(sorted(kw.items())))
    if key not in _RUNS:
        fields, frames = load_frames(name)
        out = tmp_path / "o.bit"
        if fused:
            G.CACHE.clear()
        enc = cls(E1.EncoderParams(**fields), device="cpu", fused=fused,
                  **kw)
        recons = enc.encode_sequence(frames, str(out))
        sigs = [(k, len(e.finals)) for k, e in G.CACHE.entries.items()
                if isinstance(e, FU.EncEntry)]
        _RUNS[key] = (out.read_bytes(), recons, enc, sigs)
    return _RUNS[key]


@pytest.mark.parametrize("name", CASES)
def test_fused_encode_equals_thor_tpu_and_eager(name, tmp_path, one_thread):
    """The default fused path writes thor_tpu's bytes, and so does the
    stage-wise path on the same frames."""
    data, recons, enc, _ = _encode(name, tmp_path, cls=_Watched)
    assert enc.fused and data == golden_path(name).read_bytes()
    eager, recons0, _, _ = _encode(name, tmp_path, fused=False)
    assert eager == data
    assert all(np.array_equal(a, b) for fa, fb in zip(recons, recons0)
               for a, b in zip(fa, fb))


@pytest.mark.parametrize("name", CASES)
def test_walk_map_equals_emit_map(name, tmp_path, one_thread):
    """On every P/B frame the side-info map the walk's leaves replay into
    (the final program's deblocking input) equals the emit's on every
    packed field except intra cbp, and the CLPF masks the program patches
    from its intra scans equal the emit-time masks. The I frame's final
    program (enc/fused_intra.py) takes the same way, its map patched to
    the emit's on the card."""
    _, _, enc, _ = _encode(name, tmp_path, cls=_Watched)
    n_pb = sum("measure" in ft for ft in enc.frame_times)
    assert n_pb > 0 and len(enc.maps) == len(enc.frame_times)
    for walk, emit, cm, cm_emit in enc.maps:
        intra = (emit & 1) != 0
        assert np.array_equal(walk & 1, emit & 1)
        mask = np.where(intra, 0xFF ^ 2, 0xFF).astype(np.uint8)
        assert np.array_equal(walk & mask, emit & mask)
        assert np.array_equal(cm, cm_emit)
    # the exception is real: some intra block's walk cbp differs
    assert any(((w ^ e) & 2).any() for w, e, _, _ in enc.maps) \
        or name == "ldb_qcif"


@pytest.mark.parametrize("name", CASES)
def test_fused_replay_equals_live(name, tmp_path, one_thread):
    """replay_device_frame runs the recorded frames' programs again and
    gives the live reconstruction of every P/B frame."""
    data, recons, enc, _ = _encode(name, tmp_path, record=True)
    assert data == golden_path(name).read_bytes()
    refstate = {}
    assert enc.device_record and all(r["fused"] for r in enc.device_record)
    for rec in enc.device_record:
        planes = DI.replay_device_frame(rec, refstate)
        for got, want in zip(planes, recons[rec["frame_num"]]):
            assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", CASES)
def test_signature_counts(name, tmp_path, one_thread):
    """The QCIF encodes' measure and final signatures (the graphs a card
    captures), pinned; every final belongs to one measure entry."""
    _, _, enc, sigs = _encode(name, tmp_path, cls=_Watched)
    n_pb = sum("measure" in ft for ft in enc.frame_times)
    assert (len(sigs), sum(n for _, n in sigs)) == SIGNATURES[name]
    assert len(sigs) <= n_pb


def test_bucketed_records_equal_unpadded(tmp_path, monkeypatch,
                                         one_thread):
    """Records padded past their bucket give the same planes and levels:
    kernel 6's plain version with a count (also a count of 0), and the
    final program on records padded four times further (the stream is
    still thor_tpu's)."""
    rng = np.random.default_rng(3)
    H, W = 64, 96
    tiles = [(y, x, 16) for y in range(0, H, 16) for x in range(0, W, 16)]
    n = len(tiles)
    ty, tx, s = (np.array([t[i] for t in tiles]) for i in range(3))
    recs = IT.build_intra_records(
        {"ty": ty, "tx": tx, "size": s, "mode": rng.integers(0, 10, n),
         "toplen": s + ((ty > 0) & (tx + s < W)), "leftlen": s,
         "cbx_nonzero": tx > 0}, H, W)
    planes, org = (torch.from_numpy(rng.integers(0, 256, (1, H, W)).astype(
        np.int32)) for _ in range(2))
    p0, q0 = EI.encode_scan(planes, org, torch.from_numpy(recs), 30, False,
                            False)
    pad = DF._pad(recs, DF.pow4_bucket(n), DF.INTRA_PAD)
    assert len(pad) > n
    p1, q1 = EI.encode_scan(planes, org, torch.from_numpy(pad), 30, False,
                            False, count=torch.tensor([n], dtype=torch.int32))
    assert torch.equal(p0, p1) and torch.equal(q0, q1[:n])
    assert not q1[n:].any()
    p2, q2 = EI.encode_scan(planes, org, torch.from_numpy(pad), 30, False,
                            False, count=torch.tensor([0], dtype=torch.int32))
    assert torch.equal(p2, planes) and not q2.any()

    bucket = FU._bucket

    def wider(e, key, a, fill, width):
        b, cnt = bucket(e, key, a, fill, width)
        return DF._pad(b, 4 * len(b), fill), cnt

    monkeypatch.setattr(FU, "_bucket", wider)
    fields, frames = load_frames("ldb_qcif")
    out = tmp_path / "w.bit"
    G.CACHE.clear()
    E1.Encoder(E1.EncoderParams(**fields), device="cpu").encode_sequence(
        frames, str(out))
    assert out.read_bytes() == golden_path("ldb_qcif").read_bytes()


def test_buckets_never_shrink():
    """A final input's bucket is dec/fused's power of 4 from 16, but an
    entry keeps the largest it has used, per input, so that a frame with
    fewer records reuses an earlier final program."""
    class Entry:
        caps = {}

    e = Entry()
    got = []
    for key, n in (("mc", 20), ("mc", 5), ("it", 0), ("mc", 100), ("mc", 70),
                   ("it", 3)):
        b, cnt = FU._bucket(e, key, np.ones((n, 2)), 0, 2)
        assert int(cnt[0]) == n and not b[n:].any() and b[:n].all()
        got.append(len(b))
    assert got == [64, 64, 16, 256, 256, 16]


def test_filter_tail_equals_thor_tpu():
    """The final program's filters (deblocking, the CLPF decision and
    filter, uint8 and padded planes) equal thor_tpu's _filter_fn on a QCIF
    frame: test_cif.yuv frame 1 as the reconstruction, frame 0 as the
    original, a seeded side-info map and candidate masks."""
    fields, frames = load_frames("ldb_qcif")
    H, W = fields["height"], fields["width"]
    rng = np.random.default_rng(11)
    planes = [a.astype(np.int32) for a in frames[1]]
    org_y = frames[0][0].astype(np.int32)
    dd = {k: rng.integers(0, 2, (H // 4, W // 4)) for k in ("mode", "cbp_y",
                                                           "tb_split")}
    dd["size"] = rng.choice([8, 16, 32, 64], (H // 4, W // 4))
    dd["pb_part"] = rng.integers(0, 4, (H // 4, W // 4))
    for k in ("mv0x", "mv0y", "mv1x", "mv1y"):
        dd[k] = rng.integers(-8, 9, (H // 4, W // 4))
    ddp = K.pack_ddp(dd)
    cm = np.zeros((3, H // 8, W // 8), bool)
    cm[:, :16, :16] = rng.random((3, 16, 16)) < 0.4
    qp = 32
    got = FU.filter_tail(*(torch.from_numpy(p) for p in planes),
                         torch.from_numpy(org_y), torch.from_numpy(ddp),
                         torch.from_numpy(cm), qp, H, W, True, True)
    packed, bit_sb, *ref = _filter_fn(H, W, True, True)(
        *(jnp.asarray(p) for p in planes), jnp.asarray(org_y),
        jnp.asarray(ddp), *(jnp.asarray(c) for c in cm),
        jnp.int32(BETA_TABLE[qp]), jnp.int32(TC_TABLE[qp]),
        jnp.int32(TC_TABLE[CHROMA_QP[qp]]))
    packed = np.asarray(packed)
    want = (packed[:H], packed[H:, :W // 2], packed[H:, W // 2:])
    for a, b in zip(got[:3], want):
        assert np.array_equal(a.numpy(), b)
    assert np.array_equal(got[3].numpy(), np.asarray(bit_sb))
    assert bool(np.asarray(bit_sb).any()) and not np.asarray(bit_sb).all()
    for a, b in zip(got[4], ref):
        assert np.array_equal(a.numpy(), np.asarray(b))


def _rows(size, qp, chroma, seed):
    """(q, scoeff, last) of seeded Laplace blocks and blocks built to fire
    the zero-run pass, through the port's quantizer up to the pass."""
    rng = np.random.default_rng(seed)
    qs = min(size, 16)
    rnd = np.zeros((64, size, size), np.int32)
    rnd[:, :qs, :qs] = rng.laplace(0, 60, (64, qs, qs)).astype(np.int32)
    coeff = np.concatenate([rnd, trigger_blocks(rng, size, qp, 64)])
    q, sco, last, _ = K.quant_scan(torch.from_numpy(coeff), qp, size, False,
                                   zigzag_for(qs), chroma)
    return q, sco, last


@pytest.mark.parametrize("size,qp", [(4, 30), (8, 35), (16, 29), (16, 51)])
@pytest.mark.parametrize("chroma", [False, True])
def test_rdoq_plain_equals_thor_tpu(size, qp, chroma):
    """The plain zero-run pass (the CPU side of csrc/rdoq.cu) equals
    thor_tpu's XLA scan on the same rows, luma and chroma rules."""
    q, sco, last = _rows(size, qp, chroma, size * 10 + qp + chroma)
    lg = int(np.log2(size))
    Nc = min(size, 16) ** 2
    got = K.rdoq_light(q, sco, last, qp, lg, Nc, chroma)
    want = JK._rdoq_light(jnp.asarray(q.numpy()), jnp.asarray(sco.numpy()),
                          jnp.asarray(last.numpy()), qp, lg, Nc, chroma)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert (got != q).any()


def test_failing_program_raises_and_leaves_no_entry(tmp_path, monkeypatch):
    """A program that fails (on a card: its warm-up or its capture)
    raises out of the encode; nothing falls back to the stage-wise path,
    and the failed program leaves its entry (a measure failure the cache)
    behind."""
    fields, frames = load_frames("ldb_qcif")

    def boom(*a, **kw):
        raise RuntimeError("capture failed")

    for what in ("final_program", "measure_program"):
        G.CACHE.clear()
        with monkeypatch.context() as m:
            m.setattr(FU, what, boom)
            with pytest.raises(RuntimeError, match="capture failed"):
                E1.Encoder(E1.EncoderParams(**fields), device="cpu") \
                    .encode_sequence(frames, str(tmp_path / "x.bit"))
        entries = [e for e in G.CACHE.entries.values()
                   if isinstance(e, FU.EncEntry)]
        if what == "measure_program":
            assert not entries
        else:
            assert len(entries) == 1 and not entries[0].finals


def test_store_block_equals_thor_tpu():
    """The side-info map's block store (the walk's replay before the final
    program, the emit's and the mirror's stores) equals thor_tpu's on
    seeded blocks of every size and PB split, at the frame's edges and
    overlapping."""
    from thor_tpu.codec.blockdata import DeblockData as D0
    from thor_tpu_torch.codec.blockdata import DeblockData as D1
    rng = np.random.default_rng(6)
    W, H = 200, 136
    a, b = D0(W, H), D1(W, H)
    for _ in range(2000):
        size = int(rng.choice([4, 8, 16, 32, 64]))
        y = int(rng.integers(0, H // 4)) * 4
        x = int(rng.integers(0, W // 4)) * 4
        bw, bh = min(size, W - x), min(size, H - y)

        def mvs():
            return [tuple(int(v) for v in rng.integers(-50, 50, 2))
                    for _ in range(4)]
        args = (y, x, bw, bh, size, int(rng.integers(0, 5)),
                tuple(int(v) for v in rng.integers(0, 2, 3)),
                int(rng.integers(0, 2)), int(rng.integers(0, 4)), mvs(),
                mvs(), int(rng.integers(0, 3)), int(rng.integers(0, 3)),
                int(rng.integers(-1, 3)))
        a.store_block(*args)
        b.store_block(*args)
    for k in ("mode", "size", "tb_split", "pb_part", "cbp_y", "cbp_u",
              "cbp_v", "mv0x", "mv0y", "mv1x", "mv1y", "ref_idx0",
              "ref_idx1", "bipred_flag"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k


def test_pick_rows_reads_the_spliced_order():
    """pick_rows of [uni | extra | bi] equals the rows of the spliced
    bank (device_inter._insert) without building it."""
    rng = np.random.default_rng(1)
    main = torch.from_numpy(rng.integers(-9, 9, (9, 20, 4, 4)))
    extra = torch.from_numpy(rng.integers(-9, 9, (4, 20, 4, 4)))
    K_uni = 5
    spliced = DI._insert(main, extra, K_uni)
    k = torch.from_numpy(rng.integers(0, 13, 50))
    idx = torch.from_numpy(rng.integers(0, 20, 50))
    assert torch.equal(FU.pick_rows(main, extra, K_uni, k, idx),
                       spliced[k, idx])
    assert torch.equal(FU.pick_rows(main, None, K_uni, k % 9, idx),
                       main[k % 9, idx])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("chroma", [False, True])
def test_cuda_rdoq_equals_plain(cuda, chroma):
    """csrc/rdoq.cu against the plain pass on the same rows on the card,
    every block size, rows rich in triggers; one launch a call."""
    for size in (4, 8, 16, 32, 64):
        for qp in (22, 32, 41):
            q, sco, last = (t.to(cuda) for t in _rows(size, qp, chroma,
                                                      size + qp))
            lg = int(np.log2(size))
            Nc = min(size, 16) ** 2
            n0 = K.rdoq_light.launches
            q0 = q.clone()
            got = K.rdoq_light(q, sco, last, qp, lg, Nc, chroma)
            assert K.rdoq_light.launches == n0 + 1
            want = K._rdoq_light(q, sco, last, qp, lg, Nc, chroma)
            assert torch.equal(got, want) and (got != q).any()
            assert torch.equal(q, q0)       # the kernel writes a new tensor


@pytest.mark.gpu
def test_cuda_enc_scan_count_equals_unpadded(cuda):
    """Kernel 6 on records padded to a bucket with the count on the card
    equals the unpadded launch: planes, levels, zero padded rows; a count
    of 0 leaves the planes as they were."""
    rng = np.random.default_rng(4)
    H, W = 128, 192
    tiles = [(y, x, 16) for y in range(0, H, 16) for x in range(0, W, 16)]
    n = len(tiles)
    ty, tx, s = (np.array([t[i] for t in tiles]) for i in range(3))
    recs = IT.build_intra_records(
        {"ty": ty, "tx": tx, "size": s, "mode": rng.integers(0, 10, n),
         "toplen": s + ((ty > 0) & (tx + s < W)), "leftlen": s,
         "cbx_nonzero": tx > 0}, H, W)
    planes, org = (torch.from_numpy(rng.integers(0, 256, (2, H, W)).astype(
        np.int32)).to(cuda) for _ in range(2))
    p0, q0 = EI.encode_scan(planes, org, torch.from_numpy(recs).to(cuda), 30,
                            False, False)
    pad = torch.from_numpy(DF._pad(recs, DF.pow4_bucket(n),
                                   DF.INTRA_PAD)).to(cuda)
    cnt = torch.tensor([n], dtype=torch.int32, device=cuda)
    p1, q1 = EI.encode_scan(planes, org, pad, 30, False, False, count=cnt)
    assert torch.equal(p0, p1) and torch.equal(q0, q1[:n])
    assert not q1[n:].any()
    p2, q2 = EI.encode_scan(planes, org, pad, 30, False, False,
                            count=torch.zeros(1, dtype=torch.int32,
                                              device=cuda))
    assert torch.equal(p2, planes) and not q2.any()


@pytest.mark.gpu
def test_cuda_failing_capture_raises(cuda):
    """A program that waits for the host cannot be captured: the capture
    raises, and the program keeps no graph."""
    prog = G.GraphProgram()
    with pytest.raises(RuntimeError):
        prog.run(G.lane(cuda),
                 lambda: torch.ones(4, device=cuda).sum().item())
    assert prog.graph is None
