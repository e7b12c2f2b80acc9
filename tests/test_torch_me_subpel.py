"""The motion search's quarter-pel step (thor_tpu_torch/ops/me_subpel.py):
its plain version against thor_tpu's _subpel_step on the CPU, the
wrapper's dispatch and checks, and, marked gpu, csrc/me_subpel.cu against
the plain version on the card.

Every output is integer data: the tolerance is exact equality. The cases
cover each block size, both MC filter sets, flat planes (every SAD equal:
with lam_me 0 all 49 costs tie and the first candidate wins, otherwise
the least rate), MVs at +-M_SUB with windows past the bottom and right of
the padded plane (zeros there), and the lam_me of QP 30 and 38 at the
benchmark's lambda_coeff 0.8 and 1.2.
"""

import math

import numpy as np
import pytest
import torch

from thor_tpu_torch.codec.constants import SQUARED_LAMBDA_QP
from thor_tpu_torch.enc import device_me as DM
from thor_tpu_torch.enc.device_me import me_frame
from thor_tpu_torch.ops import kernels as K
from thor_tpu_torch.ops import me_subpel as MS

from tools.gen_torch_enc_goldens import CIF, crop_frames

try:
    import jax.numpy as jnp
    from thor_tpu.enc.device_me import _subpel_step
except ImportError:     # a card's machine without JAX runs the gpu tests
    jnp = _subpel_step = None   # only: pytest --noconftest -m gpu

# the extreme lam_me of the benchmark's operating points (QP 30 at
# lambda_coeff 0.8, QP 38 at 1.2)
LAM_LO = math.sqrt(0.8 * SQUARED_LAMBDA_QP[30])
LAM_HI = math.sqrt(1.2 * SQUARED_LAMBDA_QP[38])


def _frames(H, W, n):
    """n luma planes, the top-left crop of test_cif.yuv's first frames,
    repeated over a larger area when H x W exceeds CIF."""
    out = []
    for f in crop_frames(*CIF, 352, 288, n):
        y = f[0]
        out.append(np.tile(y, (-(-H // 288), -(-W // 352)))[:H, :W])
    return out


def make_case(seed, H, W, b, R, kind="texture", lam=LAM_HI):
    """numpy inputs of one quarter-pel step: org [H, W] int32, refpad
    [R, Hp, Wp] uint8, full-pel mvy / mvx [R, HB, WB], quarter-pel
    predictors py / px [HB, WB], lam_me float32. kind: "texture"
    (test_cif frames, edge-padded by PAD), "flat" (constant planes: every
    SAD equal, reference 0's predictor its own MV: check_flat) or "edge"
    (noise, a plane padded by PAD above and left but only 8 below and
    right, MVs at +-M_SUB: windows read past the plane)."""
    rng = np.random.default_rng(seed)
    HB, WB = H // b, W // b
    P = MS.PAD
    if kind == "flat":
        org = np.full((H, W), 131, np.int32)
        refpad = np.full((R, H + 2 * P, W + 2 * P), 128, np.uint8)
    elif kind == "edge":
        org = rng.integers(0, 256, (H, W)).astype(np.int32)
        refpad = rng.integers(0, 256, (R, P + H + 8, P + W + 8)).astype(
            np.uint8)
    else:
        fr = _frames(H, W, R + 1)
        org = fr[0].astype(np.int32)
        refpad = np.stack([np.pad(f, P, mode="edge") for f in fr[1:]])
    M = MS.M_SUB
    if kind == "edge":
        pick = np.array([-M, M, M - 1, -M + 1, 0], np.int32)
        mvy = pick[rng.integers(0, 5, (R, HB, WB))]
        mvx = pick[rng.integers(0, 5, (R, HB, WB))]
        mvy[:, -1, -1] = mvx[:, -1, -1] = M
    else:
        mvy = rng.integers(-M, M + 1, (R, HB, WB)).astype(np.int32)
        mvx = rng.integers(-M, M + 1, (R, HB, WB)).astype(np.int32)
    py = rng.integers(-4 * M, 4 * M + 1, (HB, WB)).astype(np.int32)
    px = rng.integers(-4 * M, 4 * M + 1, (HB, WB)).astype(np.int32)
    if kind == "flat":
        py[:] = 4 * mvy[0]
        px[:] = 4 * mvx[0]
    return org, refpad, mvy, mvx, py, px, np.float32(lam)


def torch_args(case, b, dev):
    """subpel_search's arguments on `dev`: ob as a strided view of the
    frame, as me_frame passes it."""
    org, refpad, mvy, mvx, py, px, lam = case
    HB, WB = mvy.shape[1:]
    o = torch.from_numpy(org).to(dev)
    ob = o[:HB * b, :WB * b].reshape(HB, b, WB, b).permute(0, 2, 1, 3)
    t = (lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev))
    return (ob, t(refpad), t(mvy), t(mvx), torch.tensor(lam, device=dev),
            t(py), t(px))


def run(case, b, bipred, dev):
    ob, refpad, mvy, mvx, lam, py, px = torch_args(case, b, dev)
    return MS.subpel_search(ob, refpad, K.build_luma_mc_lut(bipred), mvy,
                            mvx, b, lam, py, px)


# (block size, seq_bipred, kind, lam_me): every size with both filter sets
# on real texture, then ties and the zero-read edge at both ends of lam_me
CPU_CASES = ([(b, bp, "texture", LAM_HI) for b in MS.SIZES for bp in (0, 1)]
             + [(b, 0, "flat", lam) for b in (8, 64)
                for lam in (0.0, LAM_HI)]
             + [(b, 1, "edge", LAM_LO) for b in (8, 16, 32, 64)])


@pytest.mark.parametrize("b,bipred,kind,lam", CPU_CASES)
def test_plain_equals_thor_tpu(b, bipred, kind, lam):
    """The plain step equals thor_tpu's _subpel_step on every reference."""
    H, W = (2 * b, 3 * b) if b >= 32 else (48, 64)
    case = make_case(b + bipred, H, W, b, 2, kind, lam)
    org, refpad, mvy, mvx, py, px, lam32 = case
    got = run(case, b, bipred, torch.device("cpu"))
    HB, WB = mvy.shape[1:]
    ob = org[:HB * b, :WB * b].reshape(HB, b, WB, b).transpose(0, 2, 1, 3)
    lut = K.build_luma_mc_lut(bipred)
    for r in range(refpad.shape[0]):
        # thor_tpu's banded slices can fall short of a plane's right edge:
        # it gets the zeros past the plane written out
        zpad = np.pad(refpad[r], ((0, 128), (0, 128)))
        want = _subpel_step(jnp.asarray(ob), jnp.asarray(zpad), lut,
                            jnp.asarray(mvy[r]), jnp.asarray(mvx[r]), b,
                            jnp.float32(lam32), jnp.asarray(py),
                            jnp.asarray(px))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[r].numpy(), np.asarray(w))
    if kind == "flat":
        check_flat(got, mvy, mvx, lam)


def check_flat(got, mvy, mvx, lam):
    """On flat planes reference 0 takes (qy, qx) = (0, 0), the least rate
    (its predictor is its own MV), or with lam_me 0, where all 49 costs
    tie, the first candidate (-3, -3)."""
    q = -3 if lam == 0 else 0
    assert (got[0][0].cpu() == 4 * torch.from_numpy(mvy[0]) + q).all()
    assert (got[1][0].cpu() == 4 * torch.from_numpy(mvx[0]) + q).all()


def test_cpu_runs_the_plain_version():
    """A CPU tensor goes to _subpel, once a reference, and launches
    nothing; M_SUB and PAD are the search's."""
    assert MS.M_SUB == DM.M_SEL and DM.PAD == MS.PAD
    case = make_case(5, 48, 64, 16, 3)
    n0, c0 = MS.subpel_search.launches, MS._subpel.calls
    got = run(case, 16, 0, torch.device("cpu"))
    assert MS.subpel_search.launches == n0
    assert MS._subpel.calls == c0 + 3
    ob, refpad, mvy, mvx, lam, py, px = torch_args(case, 16, "cpu")
    lut = K.build_luma_mc_lut(0)
    for r in range(3):
        want = MS._subpel(ob, refpad[r], lut, mvy[r], mvx[r], 16, lam, py,
                          px)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32 and torch.equal(g[r], w)


def _bad(args, what):
    ob, refpad, lut, mvy, mvx, b, lam, py, px = args
    if what == "size":
        b = 4
    elif what == "ob":
        ob = ob[:, :, :-1]
    elif what == "dtype":
        mvx = mvx.to(torch.int64)
    elif what == "lut":
        lut = lut[:8]
    elif what == "lam":
        lam = torch.stack([lam, lam])
    elif what == "refs":
        mvy = mvy[:1]
    elif what == "refpad":
        refpad = refpad.to(torch.int32)
    return ob, refpad, lut, mvy, mvx, b, lam, py, px


@pytest.mark.parametrize("what", ["size", "ob", "dtype", "lut", "lam", "refs",
                                  "refpad"])
def test_rejects_shapes_it_was_not_built_for(what):
    ob, refpad, mvy, mvx, lam, py, px = torch_args(
        make_case(1, 32, 48, 16, 2), 16, "cpu")
    args = (ob, refpad, K.build_luma_mc_lut(0), mvy, mvx, 16, lam, py, px)
    MS.subpel_search(*args)
    with pytest.raises(ValueError, match="subpel_search"):
        MS.subpel_search(*_bad(args, what))


def test_rejects_other_devices():
    ob, refpad, mvy, mvx, lam, py, px = (
        t.to("meta") for t in torch_args(make_case(1, 32, 48, 16, 2), 16,
                                         "cpu"))
    with pytest.raises(ValueError, match="unsupported device meta"):
        MS.subpel_search(ob, refpad, K.build_luma_mc_lut(0), mvy, mvx, 16,
                         lam, py, px)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _on_card(case, b, bipred, dev):
    """The kernel and the plain version on the same tensors on the card;
    one launch a call."""
    n0 = MS.subpel_search.launches
    got = run(case, b, bipred, dev)
    assert MS.subpel_search.launches == n0 + 1
    ob, refpad, mvy, mvx, lam, py, px = torch_args(case, b, dev)
    lut = K.build_luma_mc_lut(bipred)
    for r in range(refpad.shape[0]):
        want = MS._subpel(ob, refpad[r], lut, mvy[r], mvx[r], b, lam, py,
                          px)
        for g, w in zip(got, want):
            assert int((g[r].long() - w.long()).abs().max()) == 0
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("b", MS.SIZES)
@pytest.mark.parametrize("R", [1, 2, 4])
@pytest.mark.parametrize("bipred", [0, 1])
def test_cuda_equals_plain(cuda, b, R, bipred):
    """Every size, 1, 2 and 4 references, both filter sets: real texture on
    a plane whose height is no multiple of 64, ties on flat planes, and
    the zero-read edge at +-M_SUB, at both ends of lam_me."""
    for i, (kind, lam) in enumerate((("texture", LAM_HI),
                                     ("texture", LAM_LO),
                                     ("flat", 0.0), ("flat", LAM_HI),
                                     ("edge", LAM_LO), ("edge", LAM_HI))):
        case = make_case(100 * b + 10 * R + i, 200, 328, b, R, kind, lam)
        got = _on_card(case, b, bipred, cuda)
        if kind == "flat":
            check_flat(got, case[2], case[3], lam)


@pytest.mark.gpu
@pytest.mark.parametrize("b", MS.SIZES)
def test_cuda_equals_plain_1080p(cuda, b):
    """A 1920x1080 plane (1080 is no multiple of 64), two references."""
    _on_card(make_case(7 + b, 1080, 1920, b, 2), b, 0, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("bipred", [0, 1])
def test_cuda_me_frame_equals_cpu(cuda, bipred):
    """A whole me_frame on the card (the kernel at each size) equals it on
    the CPU (the plain step), every output."""
    org, refpad, *_ = make_case(3, 144, 192, 16, 2)
    lam = torch.tensor(np.float32(LAM_HI))
    want = me_frame(torch.from_numpy(org), torch.from_numpy(refpad), lam,
                    bipred)
    n0 = MS.subpel_search.launches
    got = me_frame(torch.from_numpy(org).to(cuda),
                   torch.from_numpy(refpad).to(cuda), lam.to(cuda), bipred)
    assert MS.subpel_search.launches == n0 + 4
    for s in MS.SIZES:
        for g, w in zip(got[s], want[s]):
            assert torch.equal(g.cpu(), w)
