"""Failure injection on the port's decoder, as tests/test_corrupt.py does
on thor_tpu's: truncated, bit-flipped and garbage streams must end in a
controlled error (CorruptStream, ValueError, IndexError or EOFError) or
decode, never hang or crash the process. Both parsers are probed (the
Python FrameParser and the C parse) on the numpy backend, where the
truncations and the garbage stream end as they do in thor_tpu, and on the
torch route on the CPU.
"""

import warnings

import numpy as np
import pytest
import torch

from thor_tpu.bitstream.reader import CorruptStream as TpuCorruptStream
from thor_tpu.dec.decoder import decode_file as tpu_decode_file
from thor_tpu_torch.bitstream.reader import CorruptStream
from thor_tpu_torch.dec.decoder import decode_file

from .conftest import TESTDATA

GOLD = TESTDATA / "LDB_medium_complexity.bit"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in parallel processes, and a
    busy CPU makes PyTorch's thread pool many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _try_decode(path, parse, backend="numpy"):
    """'ok' or the controlled exception's class name; any other exception
    propagates and fails the test."""
    try:
        with warnings.catch_warnings():     # clamped MC windows
            warnings.simplefilter("ignore")
            decode_file(str(path), device="cpu", backend=backend,
                        parse=parse)
        return "ok"
    except CorruptStream:
        return "CorruptStream"
    except (ValueError, IndexError, EOFError) as e:
        return type(e).__name__


def _tpu_outcome(path, parse):
    try:
        tpu_decode_file(str(path), backend="numpy", parse=parse)
        return "ok"
    except TpuCorruptStream:
        return "CorruptStream"
    except (ValueError, IndexError, EOFError) as e:
        return type(e).__name__


@pytest.fixture(scope="module")
def golden_bytes():
    return GOLD.read_bytes()


def _flips(data, n, seed=1234):
    """n copies of data, each with one bit flipped past the framing and
    the sequence header, so that the frame syntax itself is hit."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        pos = int(rng.integers(32, len(data)))
        corrupted = bytearray(data)
        corrupted[pos] ^= 1 << int(rng.integers(0, 8))
        yield bytes(corrupted)


@pytest.mark.parametrize("parse", ["python", "native"])
@pytest.mark.parametrize("cut", [0.1, 0.45, 0.8, 0.99])
def test_truncated_stream(tmp_path, golden_bytes, parse, cut):
    p = tmp_path / f"trunc_{cut}.bit"
    p.write_bytes(golden_bytes[: int(len(golden_bytes) * cut)])
    assert _try_decode(p, parse) == _tpu_outcome(p, parse)


@pytest.mark.parametrize("parse", ["python", "native"])
def test_bitflips(tmp_path, golden_bytes, parse):
    n_runs = 12 if parse == "python" else 24
    for t, data in enumerate(_flips(golden_bytes, n_runs)):
        p = tmp_path / f"flip_{t}.bit"
        p.write_bytes(data)
        _try_decode(p, parse)  # must terminate without a crash


@pytest.mark.parametrize("parse", ["python", "native"])
def test_garbage_stream(tmp_path, parse):
    rng = np.random.default_rng(7)
    p = tmp_path / "garbage.bit"
    p.write_bytes(rng.integers(0, 256, 4096, dtype=np.uint8).tobytes())
    assert _try_decode(p, parse) == _tpu_outcome(p, parse)


def test_empty_and_tiny(tmp_path):
    for n, name in ((0, "empty"), (3, "tiny"), (8, "hdr")):
        p = tmp_path / f"{name}.bit"
        p.write_bytes(b"\x00" * n)
        for parse in ("python", "native"):
            assert _try_decode(p, parse) == _tpu_outcome(p, parse)
            _try_decode(p, parse, backend="torch")


@pytest.mark.parametrize("parse", ["python", "native"])
def test_torch_route_on_corrupt_streams(tmp_path, golden_bytes, parse):
    """The pipelined route: the error of the parse thread reaches the
    caller, and a corrupt frame's inputs end in a controlled error."""
    cases = [golden_bytes[: int(len(golden_bytes) * c)]
             for c in (0.1, 0.45, 0.8, 0.99)]
    cases += list(_flips(golden_bytes, 6, seed=99))
    for t, data in enumerate(cases):
        p = tmp_path / f"case_{t}.bit"
        p.write_bytes(data)
        _try_decode(p, parse, backend="torch")
