"""The P/B-frame modules of the port's device encoder, held against
thor_tpu on the CPU.

The oracle is data: testdata/torch_enc_inter_fixtures.npz, which
tools/gen_torch_enc_goldens.py --fixtures writes from thor_tpu's own
functions (banded windows and MC, me_frame_body, _measure_fn, _trial_fn,
_final_mc_fn, the C decide walk and emit) on seeded 128x64 inputs
(fixture_inputs(): crops of testdata/test_cif.yuv). Nothing of JAX is
compiled here. Every output is integer data, so the tolerance is 0.
"""

import numpy as np
import pytest
import torch

from thor_tpu.codec.blockdata import DeblockData as DeblockData0
from thor_tpu.enc.device_inter import _collect_missing, _store_leaf_dd

from thor_tpu_torch.bitstream.writer import BitWriter
from thor_tpu_torch.codec.blockdata import DeblockData
from thor_tpu_torch.codec.constants import CHROMA_QP
from thor_tpu_torch.dec.reconstruct import mc_luts
from thor_tpu_torch.enc import device_inter as DI
from thor_tpu_torch.enc.device_me import me_frame
from thor_tpu_torch.native import decide_frame_native, emit_frame_native
from thor_tpu_torch.ops import kernels as K
from thor_tpu_torch.ops import mc as MC
from thor_tpu_torch.ops.banded_mc import M_CHROMA, M_LUMA, mc_pred_banded
from thor_tpu_torch.ops.windowed import banded_windows, banded_windows_stack

from tools.gen_torch_enc_goldens import (FIX_H, FIX_QP, FIX_W, FIXTURES,
                                         fixture_inputs)

SIZES = (8, 16, 32, 64)
H, W = FIX_H, FIX_W
QPC = int(CHROMA_QP[FIX_QP])
LEAF_FIELDS = ("ypos", "xpos", "size", "mode", "mvx", "mvy", "ref",
               "skip_idx", "intra_mode", "use_cbp", "k", "idx", "mv1x",
               "mv1y", "ref1", "dir", "tb")


@pytest.fixture(scope="module")
def fx():
    with np.load(FIXTURES) as z:
        return dict(z)


@pytest.fixture(scope="module")
def inp():
    d = fixture_inputs()
    t = {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in d.items() if isinstance(v, np.ndarray) and v.ndim}
    t["lam_me"] = torch.tensor(d["lam_me"], dtype=torch.float32)
    t["lam"] = d["lam"]
    return t


@pytest.fixture(scope="module")
def me(inp):
    return me_frame(inp["org_y"], inp["ref_y"], inp["lam_me"], 1)


@pytest.fixture(scope="module")
def variants(me, inp):
    return DI.motion_variants(me, H, W, 2, True, 0, 1, inp["sign"],
                              inp["sign_bi"])


def _eq(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    assert a.shape == np.shape(b)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", [0, 1, 2])
def test_banded_windows_match_thor_tpu(fx, inp, case):
    """Each block's window at its own offset, from one plane and from a
    stack by slot; offsets reach +-M and windows pass the plane's bottom
    and right edges (zeros there)."""
    base, bstep, w, M = (int(v) for v in fx[f"win{case}_args"])
    dy, dx, slot = (torch.from_numpy(fx[f"win{case}_{k}"])
                    for k in ("dy", "dx", "slot"))
    _eq(banded_windows(inp["ref_y"][0], dy, dx, base, base, bstep, w, M),
        fx[f"win{case}"])
    _eq(banded_windows_stack(inp["ref_y"], slot, dy, dx, base, base, bstep,
                             w, M), fx[f"win{case}_stack"])


def test_banded_windows_refuse_support_above_the_plane():
    with pytest.raises(ValueError, match="above or left"):
        z = torch.zeros((4, 4), dtype=torch.int32)
        banded_windows(torch.zeros((64, 64), dtype=torch.uint8), z, z, 5, 20,
                       8, 12, 6)


@pytest.mark.parametrize("s,lut", [(8, "y1"), (8, "c"), (16, "y1"),
                                   (16, "c"), (16, "y0"), (32, "y1"),
                                   (32, "c"), (64, "y1"), (64, "c")])
def test_mc_pred_banded_matches_thor_tpu(fx, inp, s, lut):
    """Every block size, the luma LUT with and without the bipred filter
    and the chroma LUT; the MVs reach past the clamp bounds."""
    slot, mvy, mvx = (torch.from_numpy(a) for a in fx[f"mc{s}_{lut}_mv"])
    luma = lut != "c"
    table = (K.build_luma_mc_lut(int(lut[1])) if luma
             else K.build_chroma_mc_lut())
    got = mc_pred_banded(inp["ref_y"] if luma else inp["ref_u"], slot, mvy,
                         mvx, table, 96 if luma else 48, 2 if luma else 3,
                         s if luma else s // 2, -2 if luma else -1,
                         M_LUMA if luma else M_CHROMA)
    _eq(got, fx[f"mc{s}_{lut}"])


@pytest.mark.parametrize("s", SIZES)
def test_me_frame_matches_thor_tpu(fx, me, s):
    """Per size: the best reference's quarter-pel MV, slot and cost, and
    every reference's own MV (me_frame_body, two references, bipred
    filter)."""
    for name, got in zip(("mvy", "mvx", "slot", "cost", "ref_mvy",
                          "ref_mvx"), me[s]):
        _eq(got, fx[f"me{s}_{name}"])


@pytest.mark.parametrize("s", SIZES)
def test_motion_variants_match_thor_tpu(fx, variants, s):
    """_measure_fn's variants: sign folding (slot 1 folds, slot 0 folds
    only under bipred), neighbours, zero MV per reference, bipred pairs."""
    assert set(variants[s]) == set(DI.VAR_KEYS)
    for k in DI.VAR_KEYS:
        _eq(variants[s][k], fx[f"var{s}_{k}"])


@pytest.mark.parametrize("case", ["8", "16", "32", "64", "32fast"])
def test_trial_coding_matches_thor_tpu(fx, inp, variants, case):
    """_trial_fn: every variant of a size coded, plain and (above 8) with
    the split transform; speed 0, and speed 2 at 32 (fast transforms)."""
    s = int(case[:2].rstrip("f"))
    speed = 2 if case.endswith("fast") else 0

    class P:
        encoder_speed = speed
        enable_tb_split = int(speed == 0)

    got = DI.trial_coding(
        (inp["org_y"], inp["org_u"], inp["org_v"]),
        (inp["ref_y"], inp["ref_u"], inp["ref_v"]), variants[s], s, FIX_QP,
        QPC, inp["sign"], inp["sign_bi"],
        luts=(K.build_luma_mc_lut(1), K.build_chroma_mc_lut()), k_bi=5,
        **DI._trial_flags(P, s))
    want = {k[len(f"trial{case}_"):]: fx[k] for k in fx
            if k.startswith(f"trial{case}_")}
    assert set(got) == set(want)
    for k, a in want.items():
        _eq(got[k], a)


def _field_leaves(field):
    """The fixture's seeded decided field as the port's leaves."""
    out = []
    for (y, x, s, mode, mvx, mvy, ref, mvx1, mvy1, ref1, dirf, k,
         kind) in field.tolist():
        idx = (y // s) * (W // s) + x // s
        out.append(DI.Leaf(y, x, s, mode, mv=(mvx, mvy), ref=ref, idx=idx,
                           use_cbp=kind > 0, k=k, mv1=(mvx1, mvy1),
                           ref1=ref1, dir=dirf, tb=int(kind == 2)))
    return out


def test_final_inter_matches_thor_tpu(fx, inp):
    """The final reconstruction of a seeded decided field (uni and bipred
    leaves, coded, tb-split and uncoded, intra holes) through the decoder's
    MC (kernel 2's plain version here) and the port's residual equals
    thor_tpu's banded _final_mc_fn; cbp flags mask levels that are set."""
    leaves = _field_leaves(fx["final_field"])
    trials = {}
    for s in SIZES:
        pre = f"bank{s}_"
        trials[s] = {k[len(pre):]: torch.from_numpy(fx[k]) for k in fx
                     if k.startswith(pre)}
    n0 = MC.mc_frame_plain.calls
    plan = DI.final_plan(leaves, inp["sign"].numpy(), inp["sign_bi"].numpy(),
                         H, W, torch.device("cpu"))
    plan["intra"] = None        # the inter part alone: 0 on intra leaves
    y, u, v, _, _ = DI.final_frame(
        (inp["ref_y"], inp["ref_u"], inp["ref_v"]), None, trials, plan,
        FIX_QP, QPC, mc_luts(1, "cpu"), False, H, W)
    npu = plan["npu"]
    assert MC.mc_frame_plain.calls == n0 + 2
    assert npu == sum(lf.mode != 1 for lf in leaves)
    for got, c in ((y, "y"), (u, "u"), (v, "v")):
        _eq(got, fx[f"final_{c}"])


def test_final_inter_raises_past_the_clamp(inp):
    """A window past thor_tpu's banded clamp would make the decoder's MC
    and thor_tpu's differ: the port refuses it."""
    lf = DI.Leaf(0, 0, 16, 2, mv=(4 * 60, 0))
    with pytest.raises(RuntimeError, match="clamp"):
        DI.final_plan([lf], np.zeros(2, np.int32), np.zeros(2, np.int32), H,
                      W, torch.device("cpu"))


def _walk_inputs(fx, walk=0):
    """The C walk's per-size maps: the trials' maps and the seeded intra
    costs, scaled per size as the walk's fixture says."""
    per_size = []
    for s, f in zip(SIZES, fx[f"walk{walk}_iscale"]):
        d = {k: fx[f"var{s}_{k}"] for k in ("mvy", "mvx", "slot", "mvy1",
                                            "mvx1", "slot1")}
        d.update({k[len(f"trial{s}_"):]: fx[k] for k in fx
                  if k.startswith(f"trial{s}_")
                  and not k[len(f"trial{s}_"):].startswith("q")})
        d.update(K_uni=5,
                 intra_cost=(fx[f"intra{s}_cost"] * f).astype(np.int64),
                 intra_mode=fx[f"intra{s}_mode"])
        per_size.append(d)
    return per_size


def _leaves_array(leaves):
    return np.array([[getattr(lf, f) for f in LEAF_FIELDS]
                     for lf in leaves], np.int32)


@pytest.mark.parametrize("walk", [0, 1, 2])
def test_decide_walk_matches_thor_tpu(fx, walk):
    """The copied C walk over the trials' maps (tb maps above 8) and
    seeded intra costs gives thor_tpu's leaves: at the frame's lambda, at
    a sixteenth of it, and at a sixty-fourth with dear large intra blocks
    (splits down to 8x8 skip, intra and bipred leaves)."""
    lam = float(fx[f"walk{walk}_lam"])
    leaves = decide_frame_native(W, H, 2, 1, 0, 1, 1, lam,
                                 float(np.sqrt(lam)), _walk_inputs(fx, walk))
    _eq(_leaves_array(leaves), fx[f"walk{walk}_leaves"])


def test_decide_walk_refuses_bad_maps(fx, inp):
    per_size = _walk_inputs(fx)
    per_size[1]["intra_cost"] = per_size[1]["intra_cost"][:, :-1]
    with pytest.raises(ValueError, match="wrong shape"):
        decide_frame_native(W, H, 2, 1, 0, 1, 1, inp["lam"], 1.0, per_size)


def _fixture_leaves(fx, walk):
    return [DI.Leaf(r[0], r[1], r[2], r[3], mv=(r[4], r[5]), ref=r[6],
                    skip_idx=r[7], intra_mode=r[8], use_cbp=bool(r[9]),
                    k=r[10], idx=r[11], mv1=(r[12], r[13]), ref1=r[14],
                    dir=r[15], tb=r[16])
            for r in fx[f"walk{walk}_leaves"].tolist()]


@pytest.mark.parametrize("walk", [0, 1, 2])
def test_emit_matches_thor_tpu(fx, walk):
    """The C emit of a walk's leaves writes thor_tpu's bytes, continuing
    a partial word, and fills the side-info map as thor_tpu's does."""
    leaves = _fixture_leaves(fx, walk)
    meas = {s: {k[len(f"trial{s}_"):]: fx[k] for k in fx
                if k.startswith(f"trial{s}_")} for s in SIZES}
    trials = {s: {k: torch.from_numpy(v) for k, v in meas[s].items()}
              for s in SIZES}
    coeff_host = DI.gather_coeffs(leaves, trials)
    intra = [lf for lf in leaves if lf.mode == 1]
    intra_q = {}
    if intra:
        intra_q = {c: fx[f"walk{walk}_intra_{c}"]
                   for c in ("qy", "qu", "qv")}
        for c in "yuv":
            intra_q["c" + c] = (intra_q["q" + c] != 0).any(axis=(1, 2))
        intra_q["index"] = {(lf.ypos, lf.xpos): i
                            for i, lf in enumerate(intra)}

    class P:
        enable_bipred, use_block_contexts, enable_tb_split = 1, 1, 1
        enable_pb_split, max_delta_qp = 0, 0

    class Enc:
        width, height, num_ref, interp_ref = W, H, 2, 0
        frame_type, num_intra_modes, params = 1, 4, P
        deblock_data = DeblockData(W, H)

    w = BitWriter()
    w.putbits(5, 21)
    DI.emit_frame(Enc, w, leaves, meas, coeff_host, intra_q)
    assert np.frombuffer(w.flush_frame(), np.uint8).tobytes() == \
        fx[f"walk{walk}_emit"].tobytes()
    dd = Enc.deblock_data
    _eq(np.stack([getattr(dd, k) for k in (
        "mode", "size", "tb_split", "pb_part", "cbp_y", "cbp_u", "cbp_v",
        "mv0x", "mv0y", "mv1x", "mv1y", "ref_idx0", "ref_idx1",
        "bipred_flag")]), fx[f"walk{walk}_dd"])


def test_emit_refuses_a_foreign_side_info_map():
    dd = DeblockData(64, 64)
    dd.mode = dd.mode.astype(np.int64)
    lf = DI.Leaf(0, 0, 64, 0)
    with pytest.raises(ValueError, match="int32"):
        emit_frame_native(BitWriter(), dict(
            W=64, H=64, num_ref=1, enable_bipred=0, interp_ref=0,
            use_block_contexts=0, num_intra_modes=4, max_num_tb_part=1,
            max_num_pb_part=1, max_delta_qp=0, frame_type=1), [lf],
            [0], [0], [{"qy": [], "qu": [], "qv": [], "ydim": s,
                        "cdim": s // 2} for s in SIZES]
            + [{"qy": [], "qu": [], "qv": [], "ydim": 16, "cdim": 16}], dd)


@pytest.mark.parametrize("walk", [0, 1, 2])
def test_second_chance_candidates_match_thor_tpu(fx, walk):
    """collect_missing and store_leaf_dd replay a walk's leaves as
    thor_tpu's _collect_missing and _store_leaf_dd do."""
    leaves = _fixture_leaves(fx, walk)
    meas = {}
    for s, d in zip(SIZES, _walk_inputs(fx)):
        meas[s] = d
    assert DI.collect_missing(W, H, leaves, meas) == _collect_missing(
        type("E", (), {"width": W, "height": H}), leaves, meas)
    dd0, dd1 = DeblockData0(W, H), DeblockData(W, H)
    for lf in leaves:
        _store_leaf_dd(dd0, lf, meas[lf.size])
        DI.store_leaf_dd(dd1, lf, meas[lf.size])
    for k in ("mode", "size", "tb_split", "cbp_y", "cbp_u", "cbp_v",
              "mv0x", "mv0y", "mv1x", "mv1y", "ref_idx0", "ref_idx1",
              "bipred_flag"):
        _eq(getattr(dd1, k), getattr(dd0, k))
    ev = DI.extra_variants(DI.collect_missing(W, H, leaves, meas), H, W)
    for s in SIZES:
        assert all(a.shape == (DI.K_EXTRA, (H // s) * (W // s))
                   for a in ev[s])
