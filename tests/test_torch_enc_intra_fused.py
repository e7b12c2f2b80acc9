"""The device encoder's I frame as two programs (thor_tpu_torch/enc/
fused_intra.py, Encoder(fused=True), the default) on the CPU, where the
entries run their programs through the kernels' plain versions (the CUDA
graphs are captured only on a card), and, marked gpu, on the card.

The oracle is thor_tpu: its committed device-encoder streams
(testdata/torch_enc_intra_*.bit, and the I frames of torch_enc_ldb_qcif
.bit and torch_enc_ra_qcif.bit); the port's stage-wise path
(Encoder(fused=False)) is held to the same bytes. Every value is an
integer: the tolerance is exact equality.
"""

import copy

import numpy as np
import pytest
import torch

from thor_tpu_torch.enc import device_inter as DI
from thor_tpu_torch.enc import encoder as E1
from thor_tpu_torch.enc import fused_intra as FI
from thor_tpu_torch.enc.device_intra import store_leaf_map
from thor_tpu_torch.ops import graphs as G, kernels as K

from tools.gen_torch_enc_goldens import golden_path, load_frames

INTRA = ("intra_qcif", "intra_qcif_fast", "intra_88x40", "intra_48x48")
DD_FIELDS = ("size", "tb_split", "pb_part", "mode", "cbp_y", "mv0x", "mv0y",
             "mv1x", "mv1y")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in parallel processes, and a
    busy CPU makes PyTorch's thread pool many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Watched(E1.Encoder):
    """An Encoder that keeps, per fused I frame, the side-info map and
    CLPF masks its final program used beside the emit's, and the map of
    the walk's leaves before the patch."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.maps = []

    def _filters_done(self, w, out):
        dd = self.deblock_data
        emit = K.pack_ddp({k: getattr(dd, k) for k in DD_FIELDS})
        leaves = E1.DeblockData(self.width, self.height)
        tus = [(y, x, s, 0) for y, x, s in self._leaves()]
        store_leaf_map(leaves, tus)
        self.maps.append((out["ddp"], emit, out["cm"],
                          np.stack(DI.clpf_cand_masks(dd, self.height,
                                                      self.width)),
                          leaves, copy.deepcopy(dd)))
        super()._filters_done(w, out)

    def _leaves(self):
        """The leaves of the emit's map: every block's top-left 4x4 cell
        with its size."""
        dd = self.deblock_data
        out = []
        for gy in range(dd.gh):
            for gx in range(dd.gw):
                s = int(dd.size[gy, gx])
                y, x = gy * 4, gx * 4
                if y % s == 0 and x % s == 0:
                    out.append((y, x, s))
        return out


def _encode(name, tmp_path, fused, cls=E1.Encoder, device="cpu", **kw):
    fields, frames = load_frames(name)
    out = tmp_path / f"{name}_{fused}.bit"
    enc = cls(E1.EncoderParams(**fields), device=device, fused=fused, **kw)
    recons = enc.encode_sequence(frames, str(out))
    return out.read_bytes(), recons, enc


def _same(a, b):
    return len(a) == len(b) and all(np.array_equal(p, q) for fa, fb in
                                    zip(a, b) for p, q in zip(fa, fb))


@pytest.mark.parametrize("name", INTRA)
def test_fused_intra_writes_thor_tpu_bytes_and_equals_eager(name, tmp_path):
    """The two programs write thor_tpu's bytes and the eager path's, with
    the same reconstructions and the same stage keys; the 88x40 and 48x48
    frames (empty size classes of the search) included."""
    G.CACHE.clear()
    data, recons, enc = _encode(name, tmp_path, True)
    eager, recons0, enc0 = _encode(name, tmp_path, False)
    assert data == golden_path(name).read_bytes() == eager
    assert _same(recons, recons0)
    assert [set(t) for t in enc.frame_times] == \
        [set(t) for t in enc0.frame_times] == \
        [{"search", "scan", "emit", "filters", "tus", "waits"}] * len(recons)
    entries = [e for e in G.CACHE.entries.values()
               if isinstance(e, FI.IntraEntry)]
    assert len(entries) == 1 and len(entries[0].finals) == 1


@pytest.mark.parametrize("name", ["ldb_qcif", "ra_qcif"])
def test_fused_i_frame_of_the_pb_goldens(name, tmp_path):
    """The first frame of the committed P/B streams: a one-frame encode
    with their fields writes the golden's first bytes on both paths."""
    fields, frames = load_frames(name)
    fields = dict(fields, num_frames=1)
    got = {}
    for fused in (True, False):
        out = tmp_path / f"{fused}.bit"
        E1.Encoder(E1.EncoderParams(**fields), device="cpu",
                   fused=fused).encode_sequence(frames[:1], str(out))
        got[fused] = out.read_bytes()
    assert got[True] == got[False]
    assert golden_path(name).read_bytes().startswith(got[True])


@pytest.mark.parametrize("name", ["intra_qcif", "intra_qcif_fast"])
def test_leaf_map_equals_emit_map(name, tmp_path):
    """The side-info map of the walk's leaves equals the emit's on every
    field but the cbp; patched on the card from the levels, the map the
    final program deblocks on equals the emit's packed map, and its CLPF
    candidate masks the emit's."""
    _, recons, enc = _encode(name, tmp_path, True, cls=_Watched)
    assert len(enc.maps) == len(recons)
    for ddp, emit, cm, cm_emit, leaves, dd in enc.maps:
        assert ddp is not None and np.array_equal(ddp, emit)
        assert np.array_equal(cm, cm_emit)
        for f in ("mode", "size", "tb_split", "pb_part", "mv0x", "mv0y",
                  "mv1x", "mv1y", "ref_idx0", "ref_idx1", "bipred_flag"):
            assert np.array_equal(getattr(leaves, f), getattr(dd, f)), f
        # the cbp is what the patch is for: some leaf codes no luma
        assert (dd.cbp_y == 0).any() and (leaves.cbp_y == 1).all()


@pytest.mark.parametrize("fused", [True, False])
def test_intra_replay_equals_live(fused, tmp_path):
    """replay_intra_frame runs a recorded I frame's device work again (the
    two programs, or the eager stages) and gives the live
    reconstruction."""
    _, recons, enc = _encode("intra_qcif", tmp_path, fused, record=True)
    assert len(enc.intra_record) == len(recons) == 2
    assert enc.device_record == []
    for rec in enc.intra_record:
        assert (rec["fused"] is not None) == fused
        planes = FI.replay_intra_frame(rec)
        for got, want in zip(planes, recons[rec["frame_num"]]):
            assert np.array_equal(got.numpy(), want)


def test_eager_path_makes_no_entry(tmp_path):
    """Encoder(fused=False) codes its I frames stage by stage: no entry."""
    G.CACHE.clear()
    _encode("intra_48x48", tmp_path, False)
    assert not G.CACHE.entries


def test_failing_program_raises_and_leaves_no_entry(tmp_path, monkeypatch):
    """A program that fails (on a card: its warm-up or its capture) raises
    out of the encode; nothing falls back to the eager path, a failed
    search leaves no entry and a failed final no final program."""
    def boom(*a, **kw):
        raise RuntimeError("capture failed")

    for what in ("search_program", "final_program"):
        G.CACHE.clear()
        with monkeypatch.context() as m:
            m.setattr(FI, what, boom)
            with pytest.raises(RuntimeError, match="capture failed"):
                _encode("intra_48x48", tmp_path, True)
        entries = [e for e in G.CACHE.entries.values()
                   if isinstance(e, FI.IntraEntry)]
        if what == "search_program":
            assert not entries
        else:
            assert len(entries) == 1 and not entries[0].finals


# ---------------------------------------------------------------------------
# gpu: the graphs on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["intra_qcif", "intra_88x40"])
def test_cuda_fused_intra_equals_eager_bytes(cuda, name, tmp_path):
    """On the card the two graphs write thor_tpu's bytes and the eager
    path's; a second encode replays them without capturing."""
    G.CACHE.clear()
    data, recons, _ = _encode(name, tmp_path, True, device=cuda)
    c0 = G.STATS["captures"]
    again, _, _ = _encode(name, tmp_path, True, device=cuda)
    assert G.STATS["captures"] == c0
    eager, recons0, _ = _encode(name, tmp_path, False, device=cuda)
    assert data == again == eager == golden_path(name).read_bytes()
    assert _same(recons, recons0)


@pytest.mark.gpu
def test_cuda_failing_intra_capture_raises(cuda, tmp_path, monkeypatch):
    """A search program that waits for the host cannot be captured: the
    encode raises and the entry leaves the cache."""
    G.CACHE.clear()
    real = FI.search_program

    def waits(e):
        out = real(e)
        out[0].sum().item()
        return out

    monkeypatch.setattr(FI, "search_program", waits)
    with pytest.raises(RuntimeError):
        _encode("intra_48x48", tmp_path, True, device=cuda)
    assert not [e for e in G.CACHE.entries.values()
                if isinstance(e, FI.IntraEntry)]
