"""The port's Python parse route against thor_tpu's: the VLC readers on
seeded random payloads, and on every frame of the seven CIF goldens and
RA16_long the FrameParser's syntax (header, every block record with its
coefficients, the deblock-data map, the CLPF bits, the bit categories and
the super-mode records), the C parse read back as syntax, and the frame
program's inputs built from the Python parse (dec/syntax_inputs.py) and
from the C parse. Tolerance: exact equality.
"""

import numpy as np
import pytest

from thor_tpu.bitstream.reader import BitReader as TpuBitReader
from thor_tpu.bitstream.reader import get_vlc as tpu_get_vlc
from thor_tpu.bitstream.reader import get_vlc0_limit as tpu_get_vlc0_limit
from thor_tpu.dec.parse import FrameParser as TpuFrameParser
from thor_tpu.dec.parse import SequenceHeader as TpuSequenceHeader
from thor_tpu_torch.bitstream.reader import (
    BitReader, get_vlc, get_vlc0_limit, iter_frames)
from thor_tpu_torch.dec.inputs import build_frame_inputs
from thor_tpu_torch.dec.native_adapter import native_parse_to_syntax
from thor_tpu_torch.dec.parse import FrameParser, SequenceHeader
from thor_tpu_torch.dec.syntax_inputs import syntax_to_native
from thor_tpu_torch.native import DD_KEYS, parse_frame, seqhdr_from_python

from .conftest import TESTDATA

STREAMS = ["intra_only", "LDB_low_complexity", "LDB_medium_complexity",
           "LDB_high_efficiency", "RA_low_complexity", "RA16_high_efficiency",
           "HDB16_medium_complexity", "RA16_long"]
HEADER = ("frame_type", "stat_frame_type", "qp", "num_intra_modes",
          "num_ref", "ref_array", "interp_ref_frame", "display_frame_num",
          "clpf_frame_enable", "clpf_all", "bit_cats", "super_stat")
BLOCK = ("ypos", "xpos", "size", "bwidth", "bheight", "mode", "qp",
         "intra_mode", "tb_split", "pb_part", "dir", "ref_idx0", "ref_idx1",
         "mv_arr0", "mv_arr1", "cbp")


def _read_codes(reader_cls, vlc, payload, table, n):
    """Up to n codes of one table from payload, then the bit position;
    a runaway prefix ends the list with the exception's class name."""
    br = reader_cls(payload)
    out = []
    try:
        for _ in range(n):
            out.append(vlc(table, br))
    except Exception as e:          # each package's own CorruptStream
        out.append(type(e).__name__)
    return out, br.pos


@pytest.mark.parametrize("table", range(14))
def test_get_vlc_matches_thor_tpu(table):
    """Each table on seeded random payloads, some sparse (long zero runs
    reach the escape and runaway paths), read past their end (zero
    bits)."""
    rng = np.random.default_rng(100 + table)
    for k in range(40):
        n = int(rng.integers(1, 48))
        data = rng.integers(0, 256, n, dtype=np.uint8)
        if k % 3 == 0:
            data &= rng.integers(0, 256, n, dtype=np.uint8) \
                & rng.integers(0, 256, n, dtype=np.uint8)
        payload = data.tobytes()
        got = _read_codes(BitReader, get_vlc, payload, table, 64)
        want = _read_codes(TpuBitReader, tpu_get_vlc, payload, table, 64)
        assert got == want, (table, k)


def test_get_vlc0_limit_matches_thor_tpu():
    rng = np.random.default_rng(7)
    for maxbit in range(1, 12):
        payload = (rng.integers(0, 256, 24, dtype=np.uint8)
                   & rng.integers(0, 256, 24, dtype=np.uint8)).tobytes()
        br, tb = BitReader(payload), TpuBitReader(payload)
        got = [get_vlc0_limit(maxbit, br) for _ in range(80)]
        want = [tpu_get_vlc0_limit(maxbit, tb) for _ in range(80)]
        assert got == want and br.pos == tb.pos and br.bitcnt == tb.bitcnt


def test_illegal_vlc_table_raises():
    with pytest.raises(ValueError):
        get_vlc(14, BitReader(b"\xff"))


_CACHE = {}


def _parse_stream(name):
    """(sequence header, per frame: (payload, start bit, window numbers,
    the port's Python syntax, thor_tpu's Python syntax)); cached for the
    module."""
    if name in _CACHE:
        return _CACHE[name]
    payloads = list(iter_frames(str(TESTDATA / f"{name}.bit")))
    br = BitReader(payloads[0])
    seq = SequenceHeader.read(br)
    tb = TpuBitReader(payloads[0])
    tseq = TpuSequenceHeader.read(tb)
    assert vars(seq) == vars(tseq)
    nums, pos, frames = [0] * 33, br.pos, []
    for p in payloads:
        b, t = BitReader(p), TpuBitReader(p)
        b.pos = t.pos = pos
        fs = FrameParser(seq, b, list(nums)).parse()
        ts = TpuFrameParser(tseq, t, list(nums)).parse()
        assert b.pos == t.pos
        frames.append((p, pos, list(nums), fs, ts))
        nums = [fs.display_frame_num] + nums[:-1]
        pos = 0
    _CACHE[name] = (seq, frames)
    return _CACHE[name]


def _same_syntax(fs, ts, where, block=BLOCK):
    for k in HEADER:
        assert getattr(fs, k) == getattr(ts, k), (where, k)
    if ts.clpf_bits is None:
        assert fs.clpf_bits is None, where
    else:
        assert np.array_equal(fs.clpf_bits, ts.clpf_bits), where
    for k in DD_KEYS:
        assert np.array_equal(getattr(fs.deblock_data, k),
                              getattr(ts.deblock_data, k)), (where, k)
    assert len(fs.blocks) == len(ts.blocks), where
    for i, (a, b) in enumerate(zip(fs.blocks, ts.blocks)):
        for k in block:
            assert getattr(a, k) == getattr(b, k), (where, i, k)
        for k in ("coeff_y", "coeff_u", "coeff_v"):
            x, y = getattr(a, k), getattr(b, k)
            assert x.dtype == y.dtype and np.array_equal(x, y), (where, i, k)


@pytest.mark.parametrize("name", STREAMS)
def test_frame_parser_matches_thor_tpu(name):
    seq, frames = _parse_stream(name)
    cats = set()
    for i, (_, _, _, fs, ts) in enumerate(frames):
        _same_syntax(fs, ts, (name, i))
        cats |= {k for k, v in fs.bit_cats.items() if v}
    assert {"frame_header", "super_mode", "coeff_y", "cbp"} <= cats


@pytest.mark.parametrize("name", STREAMS)
def test_native_parse_as_syntax_matches_python_parse(name):
    """The C parse read back as FrameSyntax (the numpy backend's native
    route) equals the Python parse, but for what only the Python parser
    counts (bit categories, super-mode records) and a block's pb_part,
    which the C parse keeps in the deblock-data map alone (compared), as
    thor_tpu's adapter does; no reconstruction reads the block's copy."""
    seq, frames = _parse_stream(name)
    block = tuple(k for k in BLOCK if k != "pb_part")
    for i, (p, pos, nums, fs, _) in enumerate(frames):
        ns = native_parse_to_syntax(p, pos, seq, nums)
        ns.bit_cats, ns.super_stat = fs.bit_cats, fs.super_stat
        _same_syntax(ns, fs, (name, i), block)


def _same_inputs(a, b, where):
    if isinstance(a, dict):
        assert set(a) == set(b), (where, set(a) ^ set(b))
        for k in a:
            _same_inputs(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same_inputs(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), where
    else:
        assert a == b, where


@pytest.mark.parametrize("name", STREAMS)
def test_python_route_frame_inputs_match_native_route(name):
    """The adapter plus dec/inputs.build_frame_inputs gives the frame
    program the inputs of the C parse on every frame, and lays out the
    C parse's deblock data and CLPF bits (one entry per full superblock,
    -1 where no bit was read)."""
    seq, frames = _parse_stream(name)
    cs = seqhdr_from_python(seq)
    for i, (p, pos, nums, fs, _) in enumerate(frames):
        nf = parse_frame(p, pos, cs, nums)
        ours = syntax_to_native(fs, seq)
        where = f"{name} frame {i}"
        _same_inputs(build_frame_inputs(ours, seq, nums),
                     build_frame_inputs(nf, seq, nums), where)
        for k in DD_KEYS:
            assert np.array_equal(ours.dd[k], nf.dd[k]), (where, k)
        assert np.array_equal(ours.clpf_bits, nf.clpf_bits), where
        for k in ("frame_type", "stat_frame_type", "qp", "num_intra_modes",
                  "num_ref", "interp_ref_frame", "display_frame_num",
                  "clpf_frame_enable", "clpf_all"):
            assert getattr(ours.hdr, k) == getattr(nf.hdr, k), (where, k)
        assert list(ours.hdr.ref_array) == list(nf.hdr.ref_array), where
