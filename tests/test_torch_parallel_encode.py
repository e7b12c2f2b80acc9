"""The port's GOP-parallel encoder (thor_tpu_torch/parallel/encode.py),
its eager stages (fused=False; the default, CUDA graphs on the slots'
lanes, is in tests/test_torch_parallel_fused.py), on
CPU slots and, marked gpu, on two streams of the card: the committed
thor_tpu streams (testdata/torch_enc_*.bit) byte for byte, and the
sequential port Encoder's reconstructions plane for plane. Tolerance:
equal bytes, equal planes."""

import numpy as np
import pytest
import torch

from thor_tpu_torch.enc.encoder import Encoder, EncoderParams
from thor_tpu_torch.ops import enc_intra as EI
from thor_tpu_torch.ops import interp as TI
from thor_tpu_torch.ops import mc as MC
from thor_tpu_torch.parallel.encode import ShardedEncoder

from tools.gen_torch_enc_goldens import golden_path, load_frames

# device encoder: LDB (I P P, two references) and RA (three B frames, two
# on synthesized references, in levels of 1, 1, 2); the host mirror's LDB
CASES = ["ldb_qcif", "ra_qcif", "host_ldb_qcif"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in parallel processes, and the
    P/B encodes run thousands of small tensor ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_SEQUENTIAL = {}


def _sequential(name, tmp_path_factory):
    """The sequential port Encoder's reconstructions of a case (once)."""
    if name not in _SEQUENTIAL:
        fields, frames = load_frames(name)
        out = tmp_path_factory.mktemp("seq") / f"{name}.bit"
        rec = Encoder(EncoderParams(**fields), device="cpu") \
            .encode_sequence(frames, str(out))
        assert out.read_bytes() == golden_path(name).read_bytes()
        _SEQUENTIAL[name] = rec
    return _SEQUENTIAL[name]


def _same(a, b):
    return len(a) == len(b) and all(
        np.array_equal(p, q) for fa, fb in zip(a, b) for p, q in zip(fa, fb))


@pytest.mark.parametrize("slots", [1, 2])
@pytest.mark.parametrize("name", CASES)
def test_sharded_encode_equals_sequential(name, slots, tmp_path,
                                          tmp_path_factory):
    if name == "host_ldb_qcif" and slots == 1:
        pytest.skip("the mirror runs one frame at a time either way")
    fields, frames = load_frames(name)
    out = tmp_path / "par.bit"
    se = ShardedEncoder(EncoderParams(**fields), devices=["cpu"] * slots,
                        fused=False)
    rec = se.encode_sequence(frames, str(out))
    assert out.read_bytes() == golden_path(name).read_bytes()
    assert _same(rec, _sequential(name, tmp_path_factory))
    # every frame's stage times, in coding order
    assert len(se.enc.frame_times) == fields["num_frames"]
    assert all("filters" in ft for ft in se.enc.frame_times)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["ldb_qcif", "ra_qcif"])
def test_cuda_sharded_encode_on_two_streams(name, tmp_path):
    """Two slots on one card: the committed bytes, through the kernels
    alone (no plain version called)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    plains = (MC.mc_frame_plain, EI.encode_scan_plain, TI.me_level_plain,
              TI.mot_comp_plain, TI.mot_comp_uv_plain)
    c0 = [f.calls for f in plains]
    fields, frames = load_frames(name)
    out = tmp_path / "par.bit"
    ShardedEncoder(EncoderParams(**fields), devices=["cuda:0", "cuda:0"],
                   fused=False).encode_sequence(frames, str(out))
    assert out.read_bytes() == golden_path(name).read_bytes()
    assert [f.calls for f in plains] == c0


@pytest.mark.gpu
def test_cuda_sharded_encode_across_cards(tmp_path):
    """One slot on each visible card: references and the interpolated
    frame's sources are copied to the clone's card. Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices or more")
    fields, frames = load_frames("ra_qcif")
    out = tmp_path / "par.bit"
    ShardedEncoder(EncoderParams(**fields), fused=False) \
        .encode_sequence(frames, str(out))
    assert out.read_bytes() == golden_path("ra_qcif").read_bytes()
