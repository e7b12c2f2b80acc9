"""The scaling twins at their smallest points on CPU slots, with their
equality gates: utils/scaling_curve (ShardedDecoder at gop 1 and 2 on a CIF
golden, each decode equal to the golden and to gop 1's) and
utils/encode_scaling (ShardedEncoder on 1 and 2 slots, equal to the
sequential Encoder's bytes and reconstructions)."""

import pytest
import torch

from thor_tpu_torch.utils import encode_scaling as ES
from thor_tpu_torch.utils import scaling_curve as SC

from tools.gen_torch_enc_goldens import CASES, golden_path

from .conftest import TESTDATA


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in parallel processes, and a
    busy CPU makes PyTorch's thread pool many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_scaling_curve_smallest_points():
    r = SC.measure(TESTDATA / "RA_low_complexity.bit", (1, 2), device="cpu")
    assert r["frames"] == 10 and sum(r["levels"]) == 10
    assert max(r["levels"]) >= 2
    p1, p2 = r["points"][1], r["points"][2]
    assert p1["speedup"] == 1.0 and p1["dependency_ceiling"] == 1.0
    steps = sum(-(-n // 2) for n in r["levels"])
    assert p2["dependency_ceiling"] == 10 / steps > 1


def test_encode_scaling_smallest_points():
    """At 5 frames the RA form is tools/gen_torch_enc_goldens.py's ra_qcif
    case: the stream is also thor_tpu's committed one."""
    fields = dict(CASES["ra_qcif"][2], width=176, height=144)
    assert dict(ES.RA_QCIF, num_frames=5) == fields
    r = ES.measure((1, 2), n=5, device="cpu")
    assert r["bytes"] == golden_path("ra_qcif").stat().st_size
    assert set(r["points"]) == {1, 2} and r["points"][1]["speedup"] == 1.0
