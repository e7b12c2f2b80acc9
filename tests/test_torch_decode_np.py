"""The port's numpy decode backend (dec/reconstruct_np.py, the host
interpolation of ops/temporal_interp.py through native/thor_interp.c)
against the goldens and thor_tpu's numpy decoder; the torch route fed by
the Python parser on the CPU; the C interpolation against its Python
oracle and thor_tpu's; no fallback when a C library fails to build; the
device digest. Tolerance: exact equality.
"""

import hashlib

import numpy as np
import pytest
import torch

from thor_tpu.dec.decoder import decode_file as tpu_decode_file
from thor_tpu.dec.decoder import frame_digest_np as tpu_frame_digest_np
from thor_tpu.ops import temporal_interp as TPU_TI
from thor_tpu_torch import native
from thor_tpu_torch.dec.decoder import Decoder, decode_file, frame_digest_np
from thor_tpu_torch.ops import temporal_interp as TI
from thor_tpu_torch.ops.np_kernels import pad_plane

from .conftest import TESTDATA

CIF = ["intra_only", "LDB_low_complexity", "LDB_medium_complexity",
       "LDB_high_efficiency", "RA_low_complexity", "RA16_high_efficiency",
       "HDB16_medium_complexity"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in parallel processes, and a
    busy CPU makes PyTorch's thread pool many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bytes(frames):
    return b"".join(p.tobytes() for f in frames for p in f)


def _golden_ok(name, frames):
    got = _bytes(frames)
    yuv = TESTDATA / f"{name}_dec.yuv"
    if yuv.exists():
        return got == yuv.read_bytes()
    want = (TESTDATA / f"{name}_dec.sha256").read_text().split()[0]
    return hashlib.sha256(got).hexdigest() == want


@pytest.mark.parametrize("name", CIF + ["RA16_long"])
def test_numpy_backend_native_parse(name):
    path = str(TESTDATA / f"{name}.bit")
    frames = decode_file(path, backend="numpy", parse="native")
    assert _golden_ok(name, frames)
    assert _bytes(frames) == _bytes(tpu_decode_file(path, backend="numpy",
                                                    parse="native"))


@pytest.mark.parametrize("name", ["RA_low_complexity",
                                  "HDB16_medium_complexity"])
def test_numpy_backend_python_parse(name):
    path = str(TESTDATA / f"{name}.bit")
    frames = decode_file(path, backend="numpy", parse="python")
    assert _golden_ok(name, frames)
    assert _bytes(frames) == _bytes(tpu_decode_file(path, backend="numpy",
                                                    parse="python"))


@pytest.mark.parametrize("name", ["intra_only", "LDB_low_complexity",
                                  "HDB16_medium_complexity"])
def test_torch_route_python_parse_on_cpu(name):
    """The Python parser through the adapter into the frame program (the
    kernels' plain versions on the CPU)."""
    frames = decode_file(str(TESTDATA / f"{name}.bit"), device="cpu",
                         parse="python")
    assert _golden_ok(name, frames)


class _Ref:
    def __init__(self, y, u, v):
        self.y, self.u, self.v = (pad_plane(y, 96), pad_plane(u, 48),
                                  pad_plane(v, 48))
        self.frame_num = 0


def _pair(seed, h=128, w=128):
    """Two correlated frames: a smooth seeded picture and a shifted,
    noisy copy of it."""
    rng = np.random.default_rng(seed)
    big = np.kron(rng.integers(0, 256, (h // 8 + 4, w // 8 + 4)),
                  np.ones((8, 8))).astype(np.float64)
    k = np.ones(5) / 5
    big = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, big)
    big = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, big)
    dy, dx = (int(v) for v in rng.integers(-6, 7, 2))
    a = big[16:16 + h, 16:16 + w]
    b = big[16 + dy:16 + dy + h, 16 + dx:16 + dx + w] \
        + rng.integers(-3, 4, (h, w))
    refs = []
    for p in (a, b):
        y = np.clip(p, 0, 255).astype(np.uint8)
        u = y[::2, ::2].copy()
        refs.append(_Ref(y, u, 255 - u))
    return refs


@pytest.mark.parametrize("ratio,pos", [(2, 1), (4, 3), (8, 2), (16, 7)])
def test_temporal_interp_c_copy_matches_oracles(ratio, pos):
    r0, r1 = _pair(ratio * 10 + pos)
    c = TI.interpolate_frames(r0, r1, ratio, pos)
    want = [TI.interpolate_frames(r0, r1, ratio, pos, native=False),
            TPU_TI.interpolate_frames(r0, r1, ratio, pos, native=False),
            TPU_TI.interpolate_frames(r0, r1, ratio, pos)]
    assert [p.shape for p in c] == [(128, 128), (64, 64), (64, 64)]
    for w in want:
        assert all(np.array_equal(a, b) for a, b in zip(c, w))


def test_failed_interp_build_raises(tmp_path, monkeypatch):
    """A C interpolation that does not build raises; the Python body does
    not stand in for it."""
    bad = tmp_path / "thor_interp.c"
    bad.write_text("this is not C\n")
    monkeypatch.setattr(native, "_SRC_INTERP", bad)
    monkeypatch.setattr(native, "_interp_lib", None)
    monkeypatch.setattr(TI, "_motion_estimate_bi", None)   # the oracle
    r0, r1 = _pair(1, 64, 64)
    with pytest.raises(RuntimeError, match="native build failed"):
        TI.interpolate_frames(r0, r1, 2, 1)


def test_failed_parser_build_raises(tmp_path, monkeypatch):
    """The native parse that does not build raises when a decoder is made
    for it; it does not drop to the Python parser."""
    bad = tmp_path / "thor_entropy.c"
    bad.write_text("this is not C\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "_lib", None)
    for backend in ("torch", "numpy"):
        with pytest.raises(RuntimeError, match="native build failed"):
            Decoder(device="cpu", backend=backend)
    assert Decoder(device="cpu", parse="python").parse_mode == "python"


def test_digest_on_cpu_equals_frame_digest_np():
    path = str(TESTDATA / "LDB_medium_complexity.bit")
    frames = decode_file(path, device="cpu")
    got = list(Decoder(device="cpu").decode_stream(path, digest=True))
    want = [frame_digest_np(*f) for f in frames]
    assert got == want == [tpu_frame_digest_np(*f) for f in frames]
    assert all(isinstance(d, np.uint32) for d in got)
    assert len(set(got)) == len(got)


def test_digest_needs_the_torch_backend():
    dec = Decoder(backend="numpy")
    with pytest.raises(ValueError, match="digest"):
        next(dec.decode_stream(str(TESTDATA / "intra_only.bit"),
                               digest=True))


def test_bad_backend_or_parse_raises():
    with pytest.raises(ValueError):
        Decoder(device="cpu", backend="jax")
    with pytest.raises(ValueError):
        Decoder(device="cpu", parse="fast")
    assert Decoder(device="cpu", collect_stats=True).parse_mode == "python"
