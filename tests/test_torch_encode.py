"""The device encoder's slices of the port as a whole: I frames, and P and
B frames, on the CPU (and, marked gpu, on the card).

The oracle is thor_tpu's device encoder (device_encode=1) on the same
EncoderParams and frames. A live thor_tpu encode costs minutes of XLA
compiles here, so its streams are committed as data
(testdata/torch_enc_*.bit, written by tools/gen_torch_enc_goldens.py);
the live comparison is marked slow. Tolerance: equal bytes, equal planes.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from thor_tpu_torch.dec.decoder import decode_file as decode_file1
from thor_tpu_torch.enc import encoder as E1
from thor_tpu_torch.enc.__main__ import main as enc_main, parse_args
from thor_tpu_torch.ops import enc_intra as EI
from thor_tpu_torch.ops import interp as TI
from thor_tpu_torch.ops import mc as MC
from thor_tpu_torch.utils import snr as SNR1
from thor_tpu_torch.utils import y4m as Y4M1

from tools.gen_torch_enc_goldens import (CASES, CIF, crop_frames, golden_path,
                                         load_frames)

try:
    from thor_tpu.dec.decoder import decode_file as decode_file0
    from thor_tpu.enc import encoder as E0
    from thor_tpu.utils import snr as SNR0
    from thor_tpu.utils import y4m as Y4M0
except ImportError:     # a card's machine without JAX runs the gpu tests
    decode_file0 = E0 = SNR0 = Y4M0 = None  # only: pytest --noconftest -m gpu

TESTDATA = Path(__file__).resolve().parent.parent / "testdata"
# the device encoder's cases (tests/test_torch_enc_host.py holds the
# host mirror's, device_encode=0)
DEVICE_CASES = [n for n, c in CASES.items() if c[2]["device_encode"]]
INTRA_CASES = [n for n in DEVICE_CASES
               if CASES[n][2].get("intra_period") == 1]
PB_CASES = [n for n in DEVICE_CASES if n not in INTRA_CASES]


def _same_frames(a, b):
    return len(a) == len(b) and all(
        np.array_equal(p, q) for fa, fb in zip(a, b) for p, q in zip(fa, fb))


@pytest.mark.parametrize("name", INTRA_CASES)
def test_cpu_encode_equals_thor_tpu_stream(name, tmp_path):
    """The port writes thor_tpu's bytes; its own decoder and thor_tpu's
    numpy decoder both read them back to the encoder's reconstruction."""
    fields, frames = load_frames(name)
    out = tmp_path / f"{name}.bit"
    n0, l0 = EI.encode_scan_plain.calls, EI.encode_scan.launches
    enc = E1.Encoder(E1.EncoderParams(**fields), device="cpu")
    recons = enc.encode_sequence(frames, str(out))
    assert out.read_bytes() == golden_path(name).read_bytes()
    assert len(recons) == fields["num_frames"]
    # on the CPU the wrapper takes the plain version: twice per frame
    assert EI.encode_scan_plain.calls == n0 + 2 * len(recons)
    assert EI.encode_scan.launches == l0
    assert _same_frames(decode_file1(str(out), device="cpu"), recons)
    assert _same_frames(decode_file0(str(out), backend="numpy"), recons)
    assert [set(t) for t in enc.frame_times] == [
        {"search", "scan", "emit", "filters", "tus"}] * len(recons)


@pytest.mark.parametrize("width,height,extra", [
    (176, 144, dict(deblocking=0, clpf=0, qp=38, intra_rdo=0,
                    encoder_speed=2, use_block_contexts=1)),
    (192, 136, dict(qp=30, intra_rdo=1, use_block_contexts=1,
                    max_delta_qp=2))])
def test_cpu_encode_roundtrips_beyond_the_goldens(width, height, extra,
                                                  tmp_path):
    """Parameter sets no golden has: the filters off; and a 192x136 frame,
    whose last superblock row holds 8 lines (136 = 2*64 + 8), so that the
    walk forces three splits there and the emit writes no split flag for
    the blocks that are not full. The port's decoder and thor_tpu's both
    read the stream back to the encoder's reconstruction."""
    frames = crop_frames(*CIF, width, height, 1)
    fields = dict(width=width, height=height, intra_period=1, num_frames=1,
                  device_encode=1, **extra)
    out = tmp_path / "o.bit"
    recons = E1.Encoder(E1.EncoderParams(**fields), device="cpu") \
        .encode_sequence(frames, str(out))
    assert _same_frames(decode_file1(str(out), device="cpu"), recons)
    assert _same_frames(decode_file0(str(out), backend="numpy"), recons)


@pytest.mark.slow
def test_cpu_encode_equals_live_thor_tpu(tmp_path):
    """The oracle run live (about 200 s of XLA compiles on a CPU)."""
    fields, frames = load_frames("intra_qcif")
    a, b = tmp_path / "jax.bit", tmp_path / "torch.bit"
    r0 = E0.Encoder(E0.EncoderParams(**fields)).encode_sequence(
        frames, str(a))
    r1 = E1.Encoder(E1.EncoderParams(**fields), device="cpu") \
        .encode_sequence(frames, str(b))
    assert a.read_bytes() == b.read_bytes()
    assert _same_frames(r0, r1)


def test_encoder_params_carry_across(tmp_path):
    """One dict of fields builds both EncoderParams; a config file and a
    flag list parse to the same values, floats stored as float32."""
    d = dict(width=176, height=144, qp=29, intra_period=1, num_frames=2,
             device_encode=1, intra_rdo=1, lambda_coeffI=0.9,
             frame_rate=29.97)
    assert dataclasses.asdict(E0.EncoderParams(**d)) == \
        dataclasses.asdict(E1.EncoderParams(**d))
    assert E0.SQUARED_LAMBDA_QP == E1.SQUARED_LAMBDA_QP
    assert E0.FLOAT_PARAMS == E1.FLOAT_PARAMS
    cfg = tmp_path / "a.txt"
    inc = tmp_path / "b.txt"
    inc.write_text("-qp 27 ; a comment\n-lambda_coeffI 0.85\n")
    cfg.write_text(f'-cf "{inc}"\n-n 3 -f 29.97\n-intra_rdo 1 ;x\n'
                   "-device_encode 1 -mqpP 1.1\n")
    assert E0.config_tokens(str(cfg)) == E1.config_tokens(str(cfg))
    p0 = E0.EncoderParams.from_config_file(str(cfg), width=64, height=64)
    p1 = E1.EncoderParams.from_config_file(str(cfg), width=64, height=64)
    assert dataclasses.asdict(p0) == dataclasses.asdict(p1)
    assert p1.lambda_coeffI == float(np.float32(0.85)) != 0.85
    assert (p1.qp, p1.num_frames, p1.width) == (27, 3, 64)
    with pytest.raises(ValueError, match="Unknown parameter"):
        E1.apply_args(["-no_such_flag", "1"], E1.EncoderParams(), {})
    params, files, device = parse_args(
        ["-if", "a.yuv", "-of", "b.bit", "-qp", "31x", "--device", "cpu",
         "-lambda_coeffI", "0.85"])
    assert (params.qp, files["if"], files["of"], device) == \
        (31, "a.yuv", "b.bit", "cpu")
    assert params.lambda_coeffI == p1.lambda_coeffI


def test_setup_frame_matches_thor_tpu():
    """Frame typing, QP cascade and reference lists are host arithmetic
    copied whole: the same sequence of calls gives the same state, for a
    low-delay and a dyadic random-access parameter set."""
    class Ref:
        def __init__(self, n):
            self.frame_num = n

    for extra in (dict(max_num_ref=2, HQperiod=4, dqpP=2, mqpP=1.05),
                  dict(max_num_ref=3, num_reorder_pics=7, dqpB1=3,
                       mqpB2=1.1, intra_period=16)):
        d = dict(width=64, height=64, qp=30, device_encode=1, **extra)
        e0 = E0.Encoder(E0.EncoderParams(**d))
        e1 = E1.Encoder(E1.EncoderParams(**d), device="cpu")
        sub_gop = max(1, d.get("num_reorder_pics", 0) + 1)
        last = -1
        for num_encoded in range(20):
            fn = (num_encoded if sub_gop == 1 else
                  0 if num_encoded == 0 else
                  (num_encoded - 1) // sub_gop * sub_gop + 1
                  + E1._reorder_frame_offset((num_encoded - 1) % sub_gop,
                                             sub_gop, 1) + sub_gop - 1)
            for e in (e0, e1):
                e.frame_num = fn
                e._setup_frame(num_encoded, sub_gop, 1, last)
                e.refs = [Ref(fn)] + e.refs[:-1]
            assert (e0.frame_type, e0.frame_qp, e0.num_ref, e0.ref_array,
                    e0.b_level, e0.num_intra_modes) == \
                (e1.frame_type, e1.frame_qp, e1.num_ref, e1.ref_array,
                 e1.b_level, e1.num_intra_modes)
            last = 0 if e1.frame_type != 2 else last + 1
    assert E0._reorder_frame_offset(3, 8, 1) == E1._reorder_frame_offset(
        3, 8, 1)


def test_unported_paths_raise():
    """What the port refuses: the device encoder a size that is not a
    multiple of 8 or holds no whole superblock; the host mirror a size
    that is not a multiple of 8, where thor_tpu's mirror fails."""
    for w_, h_ in ((60, 64), (88, 40)):   # not 8-aligned; no whole superblock
        with pytest.raises(ValueError, match="device encoder"):
            E1.Encoder(E1.EncoderParams(width=w_, height=h_,
                                        device_encode=1), device="cpu")
    for w_, h_ in ((172, 144), (176, 140)):
        with pytest.raises(ValueError, match="deblocking"):
            E1.Encoder(E1.EncoderParams(width=w_, height=h_), device="cpu")
    assert E1.Encoder(E1.EncoderParams(width=88, height=40),
                      device="cpu").mirror.mvcand == {}


@pytest.fixture
def one_thread():
    """The P/B encodes run thousands of small tensor ops: one intra-op
    thread keeps them from contending with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _pb_encode(name, out, device):
    """Encode a P/B case with every launch counter and plain-call counter
    read around it: (recons, encoder, {name: launches}, {name: calls})."""
    counters = (MC.mc_frame, EI.encode_scan, TI.me_level, TI.mot_comp,
                TI.mot_comp_uv)
    plains = (MC.mc_frame_plain, EI.encode_scan_plain, TI.me_level_plain,
              TI.mot_comp_plain, TI.mot_comp_uv_plain)
    l0 = [f.launches for f in counters]
    c0 = [f.calls for f in plains]
    fields, frames = load_frames(name)
    enc = E1.Encoder(E1.EncoderParams(**fields), device=device)
    recons = enc.encode_sequence(frames, str(out))
    return (recons, enc,
            {f.__name__: f.launches - n for f, n in zip(counters, l0)},
            {f.__name__: f.calls - n for f, n in zip(plains, c0)})


@pytest.mark.parametrize("name", PB_CASES)
def test_cpu_pb_encode_equals_thor_tpu_stream(name, tmp_path, one_thread):
    """P and B frames: the port writes thor_tpu's bytes (LDB with two
    references and the second chance; RA with hierarchical B frames on an
    interpolated reference, tb-split trials and the fast paths), through
    the kernels' plain versions here; its decoder and thor_tpu's numpy
    decoder read the stream back to the encoder's reconstruction."""
    out = tmp_path / f"{name}.bit"
    recons, enc, launches, calls = _pb_encode(name, out, "cpu")
    assert out.read_bytes() == golden_path(name).read_bytes()
    assert len(recons) == CASES[name][2]["num_frames"]
    assert not any(launches.values())
    pb = [ft for ft in enc.frame_times if "me" in ft]
    assert len(pb) == len(recons) - 1
    assert calls["mc_frame_plain"] == 2 * len(pb)
    assert calls["encode_scan_plain"] == 2 * (1 + sum(
        ft["intra_leaves"] > 0 for ft in pb))
    assert bool(calls["me_level_plain"]) == (name == "ra_qcif")
    assert {"me", "trials", "intra_search", "decide", "second_chance",
            "final", "emit", "filters"} <= set(pb[0])
    assert _same_frames(decode_file1(str(out), device="cpu"), recons)
    assert _same_frames(decode_file0(str(out), backend="numpy"), recons)


@pytest.mark.gpu
@pytest.mark.parametrize("name", PB_CASES)
def test_cuda_pb_encode_equals_thor_tpu_stream(name, tmp_path):
    """The same on the card: thor_tpu's bytes, through the kernels alone
    (mc_frame on every P/B frame, encode_scan on the I frame, and on the RA
    case the three synthesis kernels), no plain version called."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = tmp_path / f"{name}.bit"
    recons, enc, launches, calls = _pb_encode(name, out, "cuda")
    assert out.read_bytes() == golden_path(name).read_bytes()
    assert not any(calls.values())
    pb = [ft for ft in enc.frame_times if "me" in ft]
    assert launches["mc_frame"] == 2 * sum(ft["pus"] > 0 for ft in pb)
    assert launches["encode_scan"] == 2 * (1 + sum(
        ft["intra_leaves"] > 0 for ft in pb))
    if name == "ra_qcif":
        assert launches["me_level"] and launches["mot_comp"] \
            and launches["mot_comp_uv"]
    assert _same_frames(decode_file1(str(out), device="cuda"), recons)


def test_cli_cpu_roundtrip(tmp_path, capsys):
    """python -m thor_tpu_torch.enc on the CPU: -rf's reconstruction is
    what the port's decoder makes of the stream; y4m in, y4m out."""
    bit, rec = tmp_path / "o.bit", tmp_path / "o.yuv"
    argv = ["-if", str(TESTDATA / "test_cif.yuv"), "-of", str(bit), "-rf",
            str(rec), "-width", "352", "-height", "288", "-n", "1", "-qp",
            "36", "-intra_period", "1", "-device_encode", "1",
            "-encoder_speed", "2", "--device", "cpu"]
    assert enc_main(argv) == 0
    assert "PSNR Y" in capsys.readouterr().out
    dec = decode_file1(str(bit), device="cpu")
    assert rec.read_bytes() == b"".join(p.tobytes() for p in dec[0])
    assert enc_main(["-of", str(bit)]) == 1
    assert enc_main(argv + ["-bogus", "1"]) == 1

    y4m = tmp_path / "in.y4m"
    wtr = Y4M1.Y4MWriter(str(y4m), 352, 288, 30.0)
    wtr.write(*dec[0])
    wtr.close()
    assert Y4M0.probe_y4m(str(y4m)) == Y4M1.probe_y4m(str(y4m))
    assert Y4M1.probe_y4m(str(rec)) is None
    assert _same_frames(list(Y4M1.read_y4m_frames(str(y4m))), [dec[0]])
    frame0 = next(E1.read_yuv_frames(str(TESTDATA / "test_cif.yuv"), 352,
                                     288))
    assert SNR0.snr_yuv(frame0, dec[0]) == SNR1.snr_yuv(frame0, dec[0])
    assert SNR1.snr_plane(dec[0][0], dec[0][0]) == float("inf")


def test_clpf_decision_runs_on_the_device_ops():
    """The encoder's filters are the decoder's ops: a frame whose
    superblocks all decide for the CLPF still decodes to the encoder's
    reconstruction (covered by the goldens), and the per-superblock sums
    equal a numpy evaluation."""
    rng = np.random.default_rng(2)
    H = W = 128
    d = dict(width=W, height=H, device_encode=1, intra_period=1)
    enc = E1.Encoder(E1.EncoderParams(**d), device="cpu")
    dd = enc.deblock_data
    dd.mode[:] = 1
    dd.cbp_y[:, :16] = 1                      # the left superblock column
    dd.cbp_u[:16, 16:] = 1
    y = torch.from_numpy(rng.integers(0, 256, (H, W)).astype(np.int32))
    u, v = (torch.from_numpy(rng.integers(0, 256, (H // 2, W // 2)).astype(
        np.int32)) for _ in range(2))
    from thor_tpu.ops.np_kernels import clpf_plane_dense
    Fy = clpf_plane_dense(y.numpy().astype(np.uint8), 64, W, H).astype(
        np.int64)
    # the original: the filtered plane in the top-left superblock (the
    # filter wins there), the unfiltered one elsewhere (it loses)
    org = y.clone()
    org[:64, :64] = torch.from_numpy(Fy[:64, :64]).to(torch.int32)

    class Bits:
        def __init__(self):
            self.bits = []

        def putbits(self, n, v):
            self.bits.append((n, v))

    w = Bits()
    fy, fu, fv = enc._clpf_frame(w, y, u, v, org)
    # candidates in raster order: (0, 0) and (1, 0) by cbp_y, (0, 1) by
    # cbp_u; (1, 1) has no coded block and gets no bit
    assert w.bits == [(1, 1), (1, 0), (1, 0)]
    want_y = y.numpy().copy()
    want_y[:64, :64] = Fy[:64, :64]
    assert np.array_equal(fy.numpy(), want_y)
    assert np.array_equal(fu.numpy(), u.numpy())   # its superblock lost
    assert np.array_equal(fv.numpy(), v.numpy())   # cbp_v is 0 everywhere
