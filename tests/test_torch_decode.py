"""The port's decoder on the CPU (plain versions of its kernels) against
the committed goldens and thor_tpu's decoders; its frame inputs against
thor_tpu's input builder. Tolerance: exact equality.
"""

import hashlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from thor_tpu.dec import native_inputs as NI
from thor_tpu.dec.decoder import decode_file as tpu_decode_file
from thor_tpu.dec.native_adapter import seqhdr_from_python as tpu_seqhdr
from thor_tpu.native import parse_frame as tpu_parse_frame
from thor_tpu_torch.bitstream.reader import BitReader, iter_frames
from thor_tpu_torch.dec.decoder import decode_file
from thor_tpu_torch.dec.inputs import build_frame_inputs
from thor_tpu_torch.dec.parse import SequenceHeader
from thor_tpu_torch.native import parse_frame, seqhdr_from_python
from thor_tpu_torch.ops.mc import build_mc_pus

from .conftest import REPO, TESTDATA

STREAMS = ["intra_only", "LDB_low_complexity", "LDB_medium_complexity",
           "LDB_high_efficiency"]
# streams coded with interp_ref (RA_low_complexity synthesizes 7 references)
INTERP_STREAMS = ["RA_low_complexity", "RA16_high_efficiency",
                  "HDB16_medium_complexity"]


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


@pytest.mark.parametrize("name", STREAMS)
def test_cpu_decode_matches_golden_and_thor_tpu(name):
    path = str(TESTDATA / f"{name}.bit")
    got = _concat(decode_file(path, device="cpu"))
    golden = np.fromfile(TESTDATA / f"{name}_dec.yuv", np.uint8)
    assert got.shape == golden.shape
    assert np.array_equal(got, golden)
    assert np.array_equal(got, _concat(tpu_decode_file(path,
                                                       backend="numpy")))


@pytest.mark.slow
def test_cpu_decode_matches_thor_tpu_jax():
    """thor_tpu's JAX backend on the CPU: ~77 s of XLA compiles."""
    path = str(TESTDATA / "intra_only.bit")
    assert np.array_equal(_concat(decode_file(path, device="cpu")),
                          _concat(tpu_decode_file(path, backend="jax")))


@pytest.mark.slow
def test_cpu_decode_1080p_sha():
    from thor_tpu_torch.dec.decoder import Decoder
    h = hashlib.sha256()
    n = 0
    for planes in Decoder(device="cpu").decode_stream(
            str(TESTDATA / "LDB_medium_complexity_1080.bit")):
        for p in planes:
            h.update(p.tobytes())
        n += 1
    want = (TESTDATA / "LDB_medium_complexity_1080_dec.sha256") \
        .read_text().split()[0]
    assert n == 17 and h.hexdigest() == want


def _sha_decode(name):
    from thor_tpu_torch.dec.decoder import Decoder
    h = hashlib.sha256()
    n = 0
    for planes in Decoder(device="cpu").decode_stream(
            str(TESTDATA / f"{name}.bit")):
        for p in planes:
            h.update(p.tobytes())
        n += 1
    want = (TESTDATA / f"{name}_dec.sha256").read_text().split()[0]
    return n, h.hexdigest(), want


@pytest.mark.parametrize("name", INTERP_STREAMS)
def test_cpu_decode_interp_stream_matches_golden_and_thor_tpu(name):
    path = str(TESTDATA / f"{name}.bit")
    got = _concat(decode_file(path, device="cpu"))
    golden = np.fromfile(TESTDATA / f"{name}_dec.yuv", np.uint8)
    assert got.shape == golden.shape
    assert np.array_equal(got, golden)
    assert np.array_equal(got, _concat(tpu_decode_file(path,
                                                       backend="numpy")))


def test_cpu_decode_interp_stream_goes_through_interpolation():
    """RA_low_complexity: 7 of its 10 frames predict from a synthesized
    reference, four pyramid levels each."""
    from thor_tpu_torch.ops import interp as TI
    n0 = (TI.me_level_plain.calls, TI.mot_comp_plain.calls,
          TI.mot_comp_uv_plain.calls)
    decode_file(str(TESTDATA / "RA_low_complexity.bit"), device="cpu")
    assert (TI.me_level_plain.calls - n0[0], TI.mot_comp_plain.calls - n0[1],
            TI.mot_comp_uv_plain.calls - n0[2]) == (28, 7, 7)


def test_cpu_decode_ra16_long_sha():
    n, got, want = _sha_decode("RA16_long")
    assert n == 33 and got == want


@pytest.mark.slow
def test_cpu_decode_ra16_1080p_sha():
    """14 interpolated 1080p references through the plain ME on the CPU:
    about 70 s on eight cores."""
    n, got, want = _sha_decode("RA16_high_efficiency_1080")
    assert n == 17 and got == want


def test_cli_writes_golden(tmp_path):
    out = tmp_path / "out.yuv"
    r = subprocess.run(
        [sys.executable, "-m", "thor_tpu_torch.dec",
         str(TESTDATA / "intra_only.bit"), str(out), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert out.read_bytes() == (TESTDATA / "intra_only_dec.yuv").read_bytes()


def test_frame_inputs_match_thor_tpu():
    """Per frame of LDB_medium: the residual groups, intra TU records,
    deblock side info and CLPF masks equal thor_tpu's fused-path inputs
    (build_frame_inputs_meta), and the MC PUs its build_mc_pus_native."""
    assert _check_frame_inputs("LDB_medium_complexity") == 0


def test_frame_inputs_match_thor_tpu_interp_frames():
    """The same on RA_low_complexity, whose B frames name slot -1 (the
    interpolated reference): the slot stays -1 and its display number is
    the frame's own."""
    assert _check_frame_inputs("RA_low_complexity") == 7


def _check_frame_inputs(stream):
    """Returns the number of frames that use the interpolated reference."""
    payloads = list(iter_frames(str(TESTDATA / f"{stream}.bit")))
    n_interp = 0
    br = BitReader(payloads[0])
    seq = SequenceHeader.read(br)
    cs, cs_t = seqhdr_from_python(seq), tpu_seqhdr(seq)
    nums = [0] * 33
    pos = br.pos
    for payload in payloads:
        nf = parse_frame(payload, pos, cs, nums)
        nft = tpu_parse_frame(payload, pos, cs_t, nums)
        pos = 0
        cfg, inp, slots = build_frame_inputs(nf, seq, nums)
        _, want, wslots = NI.build_frame_inputs_meta(
            nft, seq, nums, nft.hdr.display_frame_num, seq.deblocking)
        assert slots == wslots[:cfg.R]
        for name in ("gy", "gc"):
            for s in (4, 8, 16, 32, 64):
                g, w = inp.get(f"{name}{s}"), want.get(f"{name}{s}")
                if w is None:
                    continue
                nz = w["cval"] != 0
                if g is None:
                    assert not nz.any()
                    continue
                # TUs are numbered densely and each has a nonzero coeff
                n = len(g["y"])
                assert n == w["cidx"][nz].max() // min(s, 32) ** 2 + 1
                for k in ("y", "x", "f", "a", "sh") + (
                        ("pl",) if name == "gc" else ()):
                    assert np.array_equal(g[k], w[k][:n]), (name, s, k)
                assert np.array_equal(g["cidx"], w["cidx"][nz])
                assert np.array_equal(g["cval"], w["cval"][nz])
        for ours, theirs in (("it_y", "tuy"), ("it_c", "tuc")):
            t = want[theirs]
            n = int(t["valid"].sum())
            if n == 0:
                assert ours not in inp
                continue
            exp = np.stack([t[k][:n] for k in (
                "ty", "tx", "size", "mode", "toplen", "leftlen",
                "cbx_nonzero")], axis=1)
            assert np.array_equal(inp[ours], exp)
        for k in ("ddp", "m8y", "m8u", "m8v"):
            assert np.array_equal(inp[k], want[k]), k
        assert (inp["beta"], inp["tc"], inp["tcC"]) == \
            (int(want["beta"]), int(want["tc"]), int(want["tcC"]))
        if cfg.R:
            assert inp["mc_clamped"] == 0
            dfn = nf.hdr.display_frame_num
            n_interp += -1 in slots
            fnum = np.array([nums[r] if r >= 0 else dfn for r in slots],
                            np.int64)
            pw = NI.build_mc_pus_native(nft, cfg.R, fnum,
                                        nf.hdr.display_frame_num, seq.width,
                                        seq.height)
            pg = build_mc_pus(nf, cfg.R, fnum, nf.hdr.display_frame_num,
                              seq.width, seq.height)
            for k in pw:
                assert np.array_equal(pg[k], pw[k]), k
        nums = [nf.hdr.display_frame_num] + nums[:-1]
    return n_interp
