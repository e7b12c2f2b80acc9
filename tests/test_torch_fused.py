"""The decoder's fused frame program (thor_tpu_torch/dec/fused.py) on the
CPU, where it runs the bucketed inputs through the kernels' plain
versions (the CUDA graph is captured only on a card):

  - a fused decode of every CIF-size golden equals the eager decode, the
    golden and thor_tpu's decode;
  - the residual groups' buckets (TUs, coefficient pairs) and the intra
    TU buckets equal those of thor_tpu's fused-path input build
    (native_inputs.build_frame_inputs_meta: _pack_sparse, pad_tu) on every
    frame;
  - the plain versions of kernels 1 and 2 on records padded to a bucket,
    with the real count, equal the unpadded call on seeded inputs;
  - a packed frame gives back every array it was packed from;
  - the cache's keys, its bound and the launch counts a capture records,
    with a stub capture.

One gpu-marked test decodes LDB_medium_complexity through the graphs on
the card. Tolerance: exact equality throughout.
"""

import contextlib
import gc
import itertools

import numpy as np
import pytest
import torch

from thor_tpu_torch.bitstream.reader import BitReader, iter_frames
from thor_tpu_torch.dec import fused as F
from thor_tpu_torch.dec.decoder import decode_file
from thor_tpu_torch.dec.inputs import build_frame_inputs
from thor_tpu_torch.dec.parse import SequenceHeader
from thor_tpu_torch.native import parse_frame, seqhdr_from_python
from thor_tpu_torch.ops import graphs as G, interp as TI, intra as IT
from thor_tpu_torch.ops import mc as M
from thor_tpu_torch.ops.kernels import build_chroma_mc_lut, build_luma_mc_lut

try:
    from thor_tpu.dec import native_inputs as NI
    from thor_tpu.dec.decoder import decode_file as tpu_decode_file
    from thor_tpu.dec.native_adapter import seqhdr_from_python as tpu_seqhdr
    from thor_tpu.native import parse_frame as tpu_parse_frame
except ImportError:     # a card's machine without JAX runs the gpu test
    NI = None           # only: pytest --noconftest -m gpu

from .test_torch_intra import _gen as _intra_case
from .test_torch_mc import PLANES, _case as _mc_case

try:
    from .conftest import TESTDATA
except ImportError:
    from pathlib import Path
    TESTDATA = Path(__file__).resolve().parent.parent / "testdata"

GOLDENS = ["intra_only", "LDB_low_complexity", "LDB_medium_complexity",
           "LDB_high_efficiency", "RA_low_complexity",
           "RA16_high_efficiency", "HDB16_medium_complexity"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in parallel processes, and a
    busy CPU makes PyTorch's thread pool many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _concat(frames):
    return np.concatenate([np.concatenate([y.ravel(), u.ravel(), v.ravel()])
                           for (y, u, v) in frames])


@pytest.mark.parametrize("name", GOLDENS)
def test_fused_decode_equals_eager_golden_and_thor_tpu(name):
    path = str(TESTDATA / f"{name}.bit")
    fused = _concat(decode_file(path, device="cpu", fused=True))
    eager = _concat(decode_file(path, device="cpu", fused=False))
    golden = np.fromfile(TESTDATA / f"{name}_dec.yuv", np.uint8)
    assert np.array_equal(fused, eager)
    assert np.array_equal(fused, golden)
    assert np.array_equal(fused, _concat(tpu_decode_file(path,
                                                         backend="numpy")))


def _frames(stream):
    """(seq, [(nf, nums)]) of a stream's frames with the port's parse."""
    payloads = list(iter_frames(str(TESTDATA / f"{stream}.bit")))
    br = BitReader(payloads[0])
    seq = SequenceHeader.read(br)
    cs = seqhdr_from_python(seq)
    nums = [0] * 33
    pos = br.pos
    out = []
    for payload in payloads:
        nf = parse_frame(payload, pos, cs, nums)
        out.append((payload, pos, nf, list(nums)))
        pos = 0
        nums = [nf.hdr.display_frame_num] + nums[:-1]
    return seq, out


@pytest.mark.parametrize("stream", ["intra_only", "LDB_medium_complexity",
                                    "RA_low_complexity"])
def test_buckets_equal_thor_tpu(stream):
    """Per frame and residual group: the TU bucket equals thor_tpu's npad
    and the coefficient pairs' bucket its len(cidx); a group the port
    leaves out has no TU in thor_tpu's. The intra TU buckets equal
    thor_tpu's pad_tu counts (n_intra_y / n_intra_c)."""
    seq, frames = _frames(stream)
    cs_t = tpu_seqhdr(seq)
    groups = 0
    for payload, pos, nf, nums in frames:
        nft = tpu_parse_frame(payload, pos, cs_t, nums)
        cfg, inp, _ = build_frame_inputs(nf, seq, nums)
        b = F.bucket_inputs(cfg, inp)
        tcfg, want, _ = NI.build_frame_inputs_meta(
            nft, seq, nums, nft.hdr.display_frame_num, seq.deblocking)
        for name, tgroups in (("gy", tcfg.groups_y), ("gc", tcfg.groups_c)):
            for s, npad in tgroups:
                g = b.get(f"{name}{s}")
                w = want[f"{name}{s}"]
                if g is None:
                    assert not (w["cval"] != 0).any(), (name, s)
                    continue
                groups += 1
                assert len(g["y"]) == npad, (name, s)
                assert len(g["cidx"]) == len(w["cidx"]), (name, s)
                n = len(inp[f"{name}{s}"]["cidx"])
                assert np.array_equal(g["cidx"][:n], w["cidx"][:n]), (name, s)
        for ours, theirs in (("it_y", tcfg.n_intra_y), ("it_c",
                                                         tcfg.n_intra_c)):
            if ours in b:
                assert len(b[ours]) == theirs
                assert b[ours + "_n"][0] == len(inp[ours])
    assert groups


def test_bucket_sizes():
    assert [F.pow4_bucket(n) for n in (0, 1, 16, 17, 64, 65, 300)] == \
        [16, 16, 16, 64, 64, 256, 1024]
    assert [F.pow2_bucket(n) for n in (0, 1, 64, 65, 128, 129, 1000)] == \
        [64, 64, 64, 128, 128, 256, 1024]


@pytest.mark.parametrize("plane", ["luma", "chroma"])
@pytest.mark.parametrize("has_bi", [False, True])
def test_plain_mc_count_equals_unpadded(plane, has_bi):
    H, W = (128, 192) if plane == "luma" else (64, 96)
    refs, pus = _mc_case(30 + has_bi, plane, has_bi, H, W)
    pad, fb, tap_lo, _, _, _, T = PLANES[plane]
    recs, _ = M.build_mc_records(pus, H, W, pad, fb, tap_lo, T)
    lut = build_luma_mc_lut(1) if plane == "luma" else build_chroma_mc_lut()
    lut = torch.from_numpy(lut.reshape(lut.shape[0], -1))
    padded = F.bucket_inputs(None, {"mc_y": recs})
    assert len(padded["mc_y"]) > len(recs)
    refs = torch.from_numpy(refs)
    want = M.mc_frame(refs, torch.from_numpy(recs), lut, H, W)
    got = M.mc_frame(refs, torch.from_numpy(padded["mc_y"]), lut, H, W,
                     torch.from_numpy(padded["mc_y_n"]))
    assert torch.equal(got, want)


@pytest.mark.parametrize("C, H, W, max_s, seed", [(1, 128, 128, 64, 40),
                                                  (2, 64, 96, 32, 41)])
def test_plain_intra_count_equals_unpadded(C, H, W, max_s, seed):
    tus, planes, resid = _intra_case(seed, C, H, W, max_s)
    recs = IT.build_intra_records(tus, H, W)
    padded = F.bucket_inputs(None, {"it_y": recs})
    assert len(padded["it_y"]) > len(recs)
    planes, resid = torch.from_numpy(planes), torch.from_numpy(resid)
    want = IT.intra_scan(planes, resid, torch.from_numpy(recs))
    got = IT.intra_scan(planes, resid, torch.from_numpy(padded["it_y"]),
                        torch.from_numpy(padded["it_y_n"]))
    assert torch.equal(got, want)


def test_pack_gives_back_every_array():
    seq, frames = _frames("LDB_medium_complexity")
    for _, _, nf, nums in frames[:3]:
        cfg, inp, _ = build_frame_inputs(nf, seq, nums)
        b = F.bucket_inputs(cfg, inp)
        pf = F.pack_frame(cfg, b, seq.bipred)
        got = F.unpack(pf.buf, pf.sig.layout)
        assert sorted(got) == sorted(b)
        for k, v in b.items():
            for kk, a in (v.items() if isinstance(v, dict) else [(None, v)]):
                t = got[k] if kk is None else got[k][kk]
                assert t.shape == a.shape and np.array_equal(t.numpy(), a), \
                    (k, kk)
        assert pf.sig.cfg == cfg and pf.sig.bipred == seq.bipred
        assert got["beta"].dim() == 0 and int(got["beta"]) == inp["beta"]


class _Stub:
    graph = None


def test_cache_keys_and_bound():
    cache = G.FrameCache(maxsize=3)
    made = []

    def make(k):
        made.append(k)
        return _Stub()

    cpu, other = torch.device("cpu"), torch.device("meta")
    for k in ((cpu, "a"), (cpu, "b"), (other, "a"), (cpu, "a")):
        e, fresh = cache.get(k, lambda: make(k))
        assert fresh == (made[-1] == k and made.count(k) == 1)
    assert made == [(cpu, "a"), (cpu, "b"), (other, "a")]
    ev = G.STATS["evictions"]
    cache.get((cpu, "c"), lambda: make((cpu, "c")))       # evicts (cpu, b)
    assert G.STATS["evictions"] == ev + 1
    assert list(cache.entries) == [(other, "a"), (cpu, "a"), (cpu, "c")]
    _, fresh = cache.get((cpu, "b"), lambda: make((cpu, "b")))
    assert fresh and len(cache.entries) == 3
    assert G.MAXSIZE == 256 and G.CACHE.maxsize == 256


def test_cache_forgets_pools_without_graphs(monkeypatch):
    """A graph pool dies with its last graph: a lane keeps its pool
    handle while a graph captured on it lives, and takes a new one once
    none does (a freed pool's handle must not be used again)."""
    handles = itertools.count()
    monkeypatch.setattr(torch.cuda, "graph_pool_handle",
                        lambda: (0, next(handles)))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    cache = G.FrameCache(maxsize=2)
    ln = G.Lane(torch.device("meta", 0), None, ("meta:0", "pools"))
    first = cache.pool(ln)
    prog = G.GraphProgram()
    prog.graph = object()
    ln.graphs.add(prog)
    assert cache.pool(ln) == cache.pool(ln) == first
    del prog
    gc.collect()
    second = cache.pool(ln)
    assert second != first and cache.pools == {ln: second}


def test_cache_drops_one_kind():
    """drop(kind) takes out the entries of that class only."""
    class Other(_Stub):
        pass

    cache = G.FrameCache(maxsize=4)
    a = torch.device("meta", 0)
    keep = _Stub()
    cache.get((a, "x"), lambda: keep)
    cache.get((a, "y"), Other)
    cache.get((a, "z"), Other)
    cache.drop(Other)
    assert list(cache.entries) == [(a, "x")]
    cache.drop()
    assert not cache.entries


def test_capture_counts_are_taken_back():
    """A stub capture that 'launches' both decoder kernels and the three
    interpolation kernels: its counts are returned and the wrappers'
    counters are as before."""
    counted = (M.mc_frame, IT.intra_scan, TI.me_level, TI.mot_comp,
               TI.mot_comp_uv)
    n0 = [f.launches for f in counted]

    def run():
        for i, f in enumerate(counted):
            f.launches += i + 2
        return "out"

    out, added = G.counted_capture(run)
    assert out == "out" and added == [2, 3, 0, 0, 4, 5, 6, 0]
    assert [f.launches for f in counted] == n0


def test_cpu_decode_fills_the_cache_once_per_signature():
    """A decode adds one entry per frame signature (the keys name the
    lane, the device and its stream, and the signature); a second decode
    adds none."""
    path = str(TESTDATA / "LDB_low_complexity.bit")
    seq, frames = _frames("LDB_low_complexity")
    sigs = set()
    for _, _, nf, nums in frames:
        cfg, inp, _ = build_frame_inputs(nf, seq, nums)
        sigs.add(F.pack_frame(cfg, F.bucket_inputs(cfg, inp),
                              seq.bipred).sig)
    G.CACHE.clear()
    decode_file(path, device="cpu")
    keys = set(G.CACHE.entries)
    assert keys == {(G.lane(torch.device("cpu")), s) for s in sigs}
    decode_file(path, device="cpu")
    assert set(G.CACHE.entries) == keys


@pytest.mark.gpu
def test_cuda_fused_decode_matches_golden():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    path = str(TESTDATA / "LDB_medium_complexity.bit")
    r0 = G.STATS["replays"]
    frames = decode_file(path, fused=True)
    assert G.STATS["replays"] - r0 == len(frames)
    golden = np.fromfile(TESTDATA / "LDB_medium_complexity_dec.yuv",
                         np.uint8)
    assert np.array_equal(_concat(frames), golden)
