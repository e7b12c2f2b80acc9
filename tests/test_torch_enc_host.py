"""The host mirror encoder of the port (device_encode=0) against
thor_tpu's: module by module on seeded numpy inputs, one superblock of a
seeded encoder state, the filters and padded references it hands to the
device, and whole streams: live thor_tpu encodes of tiny clips (numpy,
no XLA compile), and the check of the committed
testdata/torch_enc_host_*.bit goldens that test_torch_enc_host_intra.py
and test_torch_enc_host_inter.py run.

All data are integers: the tolerance is equal bytes and equal planes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from thor_tpu.bitstream.writer import BitWriter as BW0
from thor_tpu.codec.constants import BETA_TABLE, CHROMA_QP, TC_TABLE
from thor_tpu.enc import block as B0
from thor_tpu.enc.__main__ import main as enc_main0
from thor_tpu.enc import encoder as E0
from thor_tpu.enc import inter as I0
from thor_tpu.enc import quant as Q0
from thor_tpu.ops import np_kernels as K0

from thor_tpu_torch.bitstream.writer import BitWriter as BW1
from thor_tpu_torch.dec.decoder import decode_file
from thor_tpu_torch.enc import block as B1
from thor_tpu_torch.enc import encoder as E1
from thor_tpu_torch.enc.__main__ import main as enc_main1
from thor_tpu_torch.enc import inter as I1
from thor_tpu_torch.enc import quant as Q1
from thor_tpu_torch.ops import interp as TI
from thor_tpu_torch.ops import np_kernels as K1

from tools.gen_torch_enc_goldens import CIF, crop_frames, golden_path, \
    load_frames

def _same(a, b):
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


def _same_frames(a, b):
    return len(a) == len(b) and all(
        np.array_equal(p, q) for fa, fb in zip(a, b) for p, q in zip(fa, fb))


@pytest.fixture
def one_thread():
    """The encodes run many small torch ops (interpolation, filters on the
    CPU): one intra-op thread keeps them from contending with the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# ops/np_kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [4, 8, 16, 32, 64])
def test_transforms_and_reconstruction_match(size):
    rng = np.random.default_rng(size)
    for fast in (False, True):
        for lim in (255, 6000):     # pixel residuals; int16 wrap-around
            r = rng.integers(-lim, lim + 1, (size, size)).astype(np.int16)
            assert _same(K1.transform_fwd(r, size, fast),
                         K0.transform_fwd(r, size, fast))
    for qp in (0, 17, 32, 51):
        c = rng.integers(-400, 401, (size, size)).astype(np.int16)
        assert _same(K1.dequantize(c, qp), K0.dequantize(c, qp))
        d = K0.dequantize(c, qp)
        assert _same(K1.inverse_transform(d, size),
                     K0.inverse_transform(d, size))
        pred = rng.integers(0, 256, (size, size)).astype(np.uint8)
        res = K0.inverse_transform(d, size)
        assert _same(K1.reconstruct_block(res, pred),
                     K0.reconstruct_block(res, pred))
    x = rng.integers(-300, 600, (size, size))
    assert _same(K1.clip255(x), K0.clip255(x))
    assert all(np.array_equal(K1.TMAT[s], K0.TMAT[s]) for s in K0.TMAT)


def test_mc_matches():
    """Every fractional phase of luma (uni and bi filters, the 2/2 centre
    position) and chroma, at block shapes of the search."""
    rng = np.random.default_rng(1)
    ref = rng.integers(0, 256, (64 + 192, 96 + 192)).astype(np.uint8)
    refc = rng.integers(0, 256, (32 + 96, 48 + 96)).astype(np.uint8)
    for h, w in ((4, 4), (8, 16), (16, 8), (32, 32), (64, 64)):
        for mvy in range(-9, 9):
            for mvx in (-13, -6, -1, 0, 1, 2, 3, 7):
                for sign in (0, 1):
                    a = (ref, 96 + 8, 96 + 12, h, w, mvx, mvy, sign)
                    for bi in (0, 1):
                        assert _same(K1.mc_luma(*a, bi), K0.mc_luma(*a, bi))
                    if h <= 32:
                        c = (refc, 48 + 4, 48 + 6, h // 2, w // 2, mvx, mvy,
                             sign)
                        assert _same(K1.mc_chroma(*c), K0.mc_chroma(*c))


@pytest.mark.parametrize("size", [4, 8, 16, 32, 64])
def test_intra_prediction_matches(size):
    rng = np.random.default_rng(10 + size)
    plane = rng.integers(0, 256, (256, 256)).astype(np.uint8)
    a = rng.integers(0, 256, 2 * size).astype(np.uint8)
    assert _same(K1._filter_121(a), K0._filter_121(a))
    for ty, tx in ((0, 0), (0, 64), (64, 0), (64, 64), (32, 96)):
        for cb_x in (0, tx):
            for up in (False, True):
                for dl in (False, True):
                    args = (plane, ty, tx, cb_x, size, up, dl)
                    l0, t0, tl0 = K0.make_top_and_left(*args)
                    l1, t1, tl1 = K1.make_top_and_left(*args)
                    assert _same((l1, t1, tl1), (l0, t0, tl0))
                    for mode in range(10):
                        p = (l0, t0, tl0, ty, tx, size, mode)
                        assert _same(K1.intra_prediction(*p),
                                     K0.intra_prediction(*p))


def test_pad_plane_matches():
    a = np.random.default_rng(3).integers(0, 256, (40, 48)).astype(np.uint8)
    for pad in (48, 96):
        assert _same(K1.pad_plane(a, pad), K0.pad_plane(a, pad))


# ---------------------------------------------------------------------------
# enc/quant
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rdoq", [0, 1])
@pytest.mark.parametrize("size", [4, 8, 16, 32, 64])
def test_quantize_matches(size, rdoq):
    """Intra / inter x luma / chroma, from sparse to dense blocks, QPs
    across the range; with rdoq, the trellis truncation and the chroma DC
    case."""
    rng = np.random.default_rng(100 + size + 7 * rdoq)
    n = 0
    for qp in (4, 22, 32, 45):
        for ctype in range(4):
            for scale in (20, 200, 2000):
                c = rng.integers(-scale, scale + 1, (size, size))
                c[rng.random((size, size)) < 0.6] = 0
                c = c.astype(np.int16)
                want = Q0.quantize(c, qp, size, ctype, rdoq)
                got = Q1.quantize(c, qp, size, ctype, rdoq)
                assert _same(got, want)
                n += want[0]
    assert n > 0


# ---------------------------------------------------------------------------
# enc/inter
# ---------------------------------------------------------------------------

def _me_inputs(seed, size):
    """A padded reference and an original that is a shifted crop of it
    plus noise, so that the searches have a true motion to find."""
    rng = np.random.default_rng(seed)
    H, W = 128, 160
    base = rng.integers(0, 256, (H, W)).astype(np.int32)
    base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)) // 3
    ref = K0.pad_plane(base.astype(np.uint8), 96)
    ypos, xpos = 32, 64
    dy, dx = int(rng.integers(-6, 7)), int(rng.integers(-6, 7))
    org = np.clip(base[ypos + dy:ypos + dy + size, xpos + dx:xpos + dx + size]
                  + rng.integers(-3, 4, (size, size)), 0, 255).astype(np.uint8)
    return rng, ref, org, ypos, xpos, W, H


def test_sad_and_mv_helpers_match():
    rng, ref, org, ypos, xpos, W, H = _me_inputs(5, 16)
    by, bx = 96 + ypos, 96 + xpos
    win = ref[by:by + 16, bx:bx + 16]
    assert I1.sad_calc(org, win) == I0.sad_calc(org, win)
    assert I1.widesad_calc(org, ref, by, bx, 16, 16) == \
        I0.widesad_calc(org, ref, by, bx, 16, 16)
    assert I1.sad_calc_fasthalf(org, ref, by, bx, 16, 16) == \
        I0.sad_calc_fasthalf(org, ref, by, bx, 16, 16)
    for xin in (-2, 0, 2):
        for yin in (-2, 0, 2):
            a = (org, ref, by, bx, 16, 16, xin, yin)
            assert I1.sad_calc_fastquarter(*a) == I0.sad_calc_fastquarter(*a)
    for _ in range(200):
        mvx, mvy = (int(v) for v in rng.integers(-600, 600, 2))
        a = (mvx, mvy, int(rng.integers(0, 128)), int(rng.integers(0, 160)),
             160, 128, int(rng.choice([8, 16, 32, 64])), int(rng.integers(2)))
        assert I1.clip_mv(*a) == I0.clip_mv(*a)
        assert I1.quote_mv_bits(mvy, mvx) == I0.quote_mv_bits(mvy, mvx)
    c0, c1 = I0.MVCandList(), I1.MVCandList()
    for mv in rng.integers(-40, 40, (50, 2)):
        I0.add_mvcandidate(tuple(int(v) for v in mv), c0)
        I1.add_mvcandidate(tuple(int(v) for v in mv), c1)
    assert (c0.slots, c0.num, c0.mask) == (c1.slots, c1.num, c1.mask)
    c0.reset()
    c1.reset()
    assert (list(c0), c0.slots) == (list(c1), c1.slots)


@pytest.mark.parametrize("speed,sync", [(0, 0), (1, 0), (2, 0), (0, 1)])
@pytest.mark.parametrize("size", [8, 16, 32])
def test_motion_estimation_matches(size, speed, sync):
    """motion_estimate (full-search steps, candidates, hexagon, sub-pel by
    MC or by the fast bilinear forms), the partitioned dispatch, the
    symmetric bipred search and the sync search, each with the candidate
    list it reads and writes."""
    rng, ref, org, ypos, xpos, W, H = _me_inputs(size + 10 * speed, size)
    p = E1.EncoderParams(encoder_speed=speed, sync=sync)
    binfo = B1.BlockInfo(size=size, ypos=ypos, xpos=xpos, bwidth=size,
                         bheight=size)
    mvp = (int(rng.integers(-20, 20)), int(rng.integers(-20, 20)))
    for sign in (0, 1):
        cands = [I0.MVCandList(), I1.MVCandList()]
        for mv in rng.integers(-30, 30, (5, 2)):
            for c, mod in zip(cands, (I0, I1)):
                mod.add_mvcandidate(tuple(int(v) for v in mv), c)
        for part in range(4):
            for bi in (0, 1):
                outs = [mod.search_inter_prediction_params(
                    org, ref, binfo, (4, -8), mvp, part, 7.5, p, sign, W, H,
                    c, bi) for mod, c in zip((I0, I1), cands)]
                assert outs[0] == outs[1]
        outs = [mod.motion_estimate_bi(
            org, ref, ref, size, size, size, (4, -8), mvp, 7.5, p, sign,
            W, H, xpos, ypos, c, 1) for mod, c in zip((I0, I1), cands)]
        assert outs[0] == outs[1]
        assert cands[0].slots == cands[1].slots


# ---------------------------------------------------------------------------
# enc/block: one superblock of a seeded encoder state
# ---------------------------------------------------------------------------

def _seeded_state(frame_type, fields, seed):
    """thor_tpu's Encoder and the port's mirror over the same seeded
    state: a 128x128 crop of test_cif frame 1 as the original, frames 0
    and 2 (reconstructions with noise) as two references, a partly coded
    frame (the rec planes and deblocking data of a seeded first
    superblock), the frame context of a P or B frame."""
    rng = np.random.default_rng(seed)
    W = H = 128
    fr = crop_frames(*CIF, W, H, 3)
    noisy = [tuple(np.clip(p.astype(np.int32)
                           + rng.integers(-4, 5, p.shape), 0, 255)
                   .astype(np.uint8) for p in f) for f in (fr[0], fr[2])]
    d = dict(width=W, height=H, qp=32, max_num_ref=2, enable_bipred=1,
             **fields)
    e0 = E0.Encoder(E0.EncoderParams(**d))
    e1 = E1.Encoder(E1.EncoderParams(**d), device="cpu")
    for e in (e0, e1):
        e.frame_type, e.frame_qp, e.frame_num = frame_type, 32, 1
        e.num_ref, e.ref_array = 2, [0, 1]
        e.lambda_ = 1.0 * E1.SQUARED_LAMBDA_QP[32]
        e.num_intra_modes = 10
    nums = (0, 2) if frame_type == 2 else (0, -1)
    e0.refs[:2] = [E0.RefFrame(*f, n) for f, n in zip(noisy, nums)]
    e1.refs[:2] = [E1.RefFrame(*(torch.from_numpy(p) for p in f), n)
                   for f, n in zip(noisy, nums)]
    m = e1.mirror
    e0.org_y, e0.org_u, e0.org_v = fr[1]
    m.org_y, m.org_u, m.org_v = fr[1]
    rec = [rng.integers(0, 256, p.shape).astype(np.uint8) for p in fr[1]]
    e0.rec_y, e0.rec_u, e0.rec_v = (a.copy() for a in rec)
    m.rec_y, m.rec_u, m.rec_v = (a.copy() for a in rec)
    for e in (e0, e1):
        e.deblock_data.store_block(0, 0, 64, 64, 64, 2, (1, 0, 1), 0, 0,
                                   [(12, -4)] * 4, [(0, 0)] * 4, 1, 0, 0)
    return e0, m


@pytest.mark.parametrize("frame_type,fields", [
    (0, dict(intra_rdo=1, rdoq=1, max_delta_qp=1, use_block_contexts=1)),
    (1, dict(use_block_contexts=1, enable_tb_split=1)),
    (1, dict(encoder_speed=1, early_skip_thr=0.8, enable_pb_split=1)),
    (2, dict(encoder_speed=0, interp_ref=0))])
def test_process_block_matches(frame_type, fields):
    """process_block on the superblock right of a coded one: the same
    bytes through the BitWriter, the same rec planes, deblocking data and
    ME candidate state."""
    e0, m = _seeded_state(frame_type, fields, 3 + frame_type)
    w0, w1 = BW0(), BW1()
    for w in (w0, w1):
        w.putbits(7, 0x55)
    # two QPs on the I frame: the delta-QP trial codes a superblock twice
    for qp in ((31, 32) if frame_type == 0 else (32,)):
        c0 = B0.process_block(e0, w0, 64, 0, 64, qp)
        c1 = B1.process_block(m, w1, 64, 0, 64, qp)
        assert c0 == c1
        assert w0.get_bit_pos() == w1.get_bit_pos()
    assert w0.flush_frame() == w1.flush_frame()
    for a, b in zip((e0.rec_y, e0.rec_u, e0.rec_v),
                    (m.rec_y, m.rec_u, m.rec_v)):
        assert np.array_equal(a, b)
    for k in vars(e0.deblock_data):
        assert np.array_equal(getattr(e0.deblock_data, k),
                              getattr(m.deblock_data, k)), k
    assert {k: (c.slots, c.num, c.mask) for k, c in e0.mvcand.items()} == \
        {k: (c.slots, c.num, c.mask) for k, c in m.mvcand.items()}
    assert e0.best_ref == m.best_ref


# ---------------------------------------------------------------------------
# what the mirror hands to the device and takes from it
# ---------------------------------------------------------------------------

def test_host_copies_equal_pad_plane(one_thread):
    """The mirror reads host copies of the padded references: a window
    frame padded on the device by edge_pad, and an interpolated frame whose
    padding the synthesis writes; each equals pad_plane of its planes."""
    fr = crop_frames(*CIF, 176, 144, 3)
    e = E1.Encoder(E1.EncoderParams(width=176, height=144), device="cpu")
    e.refs[:2] = [E1.RefFrame(*(torch.from_numpy(p) for p in f), n)
                  for f, n in zip((fr[2], fr[0]), (2, 0))]
    e.frame_num = 1
    e._synth_interp(0, 1, 2, 1)
    for ref, planes in ((e.refs[0], fr[2]), (e.refs[1], fr[0]),
                        (e.interp_frame, None)):
        h = ref.host()
        assert h is ref.host() and h.frame_num == ref.frame_num
        if planes is None:      # the synthesized frame's interior
            planes = (h.y[96:-96, 96:-96], h.u[48:-48, 48:-48],
                      h.v[48:-48, 48:-48])
        for a, p, pad in zip((h.y, h.u, h.v), planes, (96, 48, 48)):
            assert a.dtype == np.uint8
            assert np.array_equal(a, K0.pad_plane(p, pad))


def _random_deblock_data(dd, rng, W, H):
    """Leaves of a random quadtree over the frame with random modes,
    coded-block flags, splits and vectors, stored as the encoder stores
    them (partial blocks at the right and bottom edges)."""
    def leaf(s, y, x):
        if y >= H or x >= W:
            return
        if s > 8 and (y + s > H or x + s > W or rng.random() < 0.5):
            for dy in (0, s // 2):
                for dx in (0, s // 2):
                    leaf(s // 2, y + dy, x + dx)
            return
        mv = [tuple(int(v) for v in rng.integers(-12, 13, 2))
              for _ in range(4)]
        mode = int(rng.integers(0, 5))
        dd.store_block(y, x, min(s, W - x), min(s, H - y), s, mode,
                       tuple(int(v) for v in rng.integers(0, 2, 3)),
                       int(rng.integers(0, 2)), int(rng.integers(0, 4)),
                       mv, mv[::-1], 0, 1, 2 if mode == 3 else 0)
    for y in range(0, H, 64):
        for x in range(0, W, 64):
            leaf(64, y, x)


@pytest.mark.parametrize("W,H", [(352, 288), (48, 40)])
def test_device_filters_match_the_mirror_filters(W, H):
    """The mirror's frame end runs on the device ops (Encoder._filters):
    deblocking and the CLPF decision and filter give thor_tpu's numpy
    mirror's planes and bits, on CIF (the last superblock row holds 32
    lines) and on a frame smaller than one superblock."""
    rng = np.random.default_rng(W)
    e0 = E0.Encoder(E0.EncoderParams(width=W, height=H))
    e1 = E1.Encoder(E1.EncoderParams(width=W, height=H), device="cpu")
    fr = crop_frames(*CIF, W, H, 1)[0]
    for trial in range(3):
        for e in (e0, e1):
            e.deblock_data.reset()
        _random_deblock_data(e0.deblock_data, rng, W, H)
        for k in vars(e0.deblock_data):
            a = getattr(e0.deblock_data, k)
            if isinstance(a, np.ndarray):
                getattr(e1.deblock_data, k)[:] = a
        rec = [np.clip(p.astype(np.int32) + rng.integers(-9, 10, p.shape),
                       0, 255).astype(np.uint8) for p in fr]
        qp = int(rng.integers(22, 45))
        e0.frame_qp = e1.frame_qp = qp
        y, u, v = (a.copy() for a in rec)
        K0.deblock_frame_y(y, e0.deblock_data, W, H, qp, BETA_TABLE,
                           TC_TABLE)
        K0.deblock_frame_uv(u, v, e0.deblock_data, W, H, int(CHROMA_QP[qp]),
                            TC_TABLE)
        e0.rec_y, e0.rec_u, e0.rec_v = y, u, v
        e0.org_y = fr[0]
        w0 = BW0()
        w0.putbits(1, 1)
        w0.putbits(1, 0)
        e0._clpf_frame(w0)
        w1 = BW1()
        e1.frame_times.append({})
        e1._filters(w1, *(torch.from_numpy(a.astype(np.int32))
                          for a in rec), torch.from_numpy(
                              fr[0].astype(np.int32)))
        assert w0.flush_frame() == w1.flush_frame()
        for a, b in zip((e0.rec_y, e0.rec_u, e0.rec_v),
                        (e1.rec_y, e1.rec_u, e1.rec_v)):
            assert np.array_equal(a, b.numpy())
        assert set(e1.frame_times[-1]) == {"filters"}


# ---------------------------------------------------------------------------
# whole streams
# ---------------------------------------------------------------------------

def check_host_golden(name, tmp_path):
    """The port's mirror on the CPU writes the committed golden of case
    `name` (thor_tpu's mirror bytes), one frame time dict of the mirror's
    two stages per frame; RA frames synthesize their interpolated
    reference on the device (here the kernels' plain versions); the port's
    decoder reads the stream back to the encoder's reconstruction.
    tests/test_torch_enc_host_intra.py and test_torch_enc_host_inter.py
    run it per case."""
    plains = (TI.me_level_plain, TI.mot_comp_plain, TI.mot_comp_uv_plain)
    c0 = [f.calls for f in plains]
    fields, frames = load_frames(name)
    out = tmp_path / f"{name}.bit"
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        enc = E1.Encoder(E1.EncoderParams(**fields), device="cpu")
        recons = enc.encode_sequence(frames, str(out))
    finally:
        torch.set_num_threads(n)
    assert out.read_bytes() == golden_path(name).read_bytes()
    assert len(recons) == fields["num_frames"]
    assert [set(t) for t in enc.frame_times] == \
        [{"search", "filters", "waits"}] * len(recons)
    synth = [f.calls - k for f, k in zip(plains, c0)]
    assert all(synth) == bool(fields.get("interp_ref"))
    assert _same_frames(decode_file(str(out), device="cpu"), recons)


LIVE = {
    # smaller than a superblock; early skip, PB split, RDOQ, fast search
    "tiny_skip_pbsplit": (48, 40, dict(
        num_frames=3, qp=34, early_skip_thr=1.2, enable_pb_split=1,
        rdoq=1, encoder_speed=1, max_num_ref=2)),
    # the sync search (ME by MC at every step)
    "tiny_sync": (48, 40, dict(
        num_frames=3, qp=30, sync=1, max_num_ref=2, enable_bipred=1)),
    # hierarchical B frames with the interpolated reference at the
    # fastest speed
    "ra_fast": (64, 64, dict(
        num_frames=5, qp=30, num_reorder_pics=3, interp_ref=1,
        max_num_ref=2, enable_bipred=1, encoder_speed=2)),
}


@pytest.mark.parametrize("name", list(LIVE))
def test_host_encode_equals_live_thor_tpu(name, tmp_path, one_thread):
    """Parameter sets no golden has, against a live thor_tpu mirror encode
    of the same tiny clip: the same bytes and reconstruction."""
    W, H, f = LIVE[name]
    frames = crop_frames(*CIF, W, H, f["num_frames"])
    d = dict(f, width=W, height=H)
    r0 = E0.Encoder(E0.EncoderParams(**d)).encode_sequence(
        frames, str(tmp_path / "a.bit"))
    r1 = E1.Encoder(E1.EncoderParams(**d), device="cpu").encode_sequence(
        frames, str(tmp_path / "b.bit"))
    assert (tmp_path / "a.bit").read_bytes() == \
        (tmp_path / "b.bit").read_bytes()
    assert _same_frames(r0, r1)
    assert _same_frames(decode_file(str(tmp_path / "b.bit"), device="cpu"),
                        r1)


@pytest.mark.parametrize("W,H,error", [(44, 40, ZeroDivisionError),
                                       (40, 36, IndexError)])
def test_mirror_refuses_the_sizes_thor_tpu_fails_on(W, H, error, tmp_path):
    """A width or a height that is not a multiple of 8: thor_tpu's mirror,
    the reference the port's is held to, fails in its luma deblocking
    (thor_tpu/ops/np_kernels.py:376: pos % q_size with q_size 0, or a row
    past the plane), so there are no bytes to match and the port's mirror
    refuses the size."""
    d = dict(width=W, height=H, num_frames=1)
    with pytest.raises(error):
        E0.Encoder(E0.EncoderParams(**d)).encode_sequence(
            crop_frames(*CIF, W, H, 1), str(tmp_path / "a.bit"))
    with pytest.raises(ValueError, match="deblocking"):
        E1.Encoder(E1.EncoderParams(**d), device="cpu")


def test_tb_split_flags_fault_is_thor_tpu_s(tmp_path, monkeypatch):
    """thor_tpu's mirror stores a tb-split block's coded-block flags as
    "some quadrant of the plane is coded" (thor_tpu/enc/encoder.py:271-281)
    where the decoder stores (1, 1, 1) for every tb-split block
    (thor_tpu/dec/parse.py:661, :694); the encoder's deblocking and CLPF
    then filter other cells than the decoder's, so its reconstruction is
    not what its stream decodes to. The port writes thor_tpu's bytes and
    reconstruction, fault included: on this 64x64 intra frame one U pixel
    differs. With the decoder's flags the two agree."""
    d = dict(width=64, height=64, num_frames=1, intra_period=1,
             enable_tb_split=1)
    frames = crop_frames(*CIF, 64, 64, 1)
    out0, out1 = tmp_path / "a.bit", tmp_path / "b.bit"
    r0 = E0.Encoder(E0.EncoderParams(**d)).encode_sequence(frames, str(out0))
    r1 = E1.Encoder(E1.EncoderParams(**d), device="cpu").encode_sequence(
        frames, str(out1))
    assert out0.read_bytes() == out1.read_bytes() and _same_frames(r0, r1)
    dec = decode_file(str(out1), device="cpu")
    assert [int((a != b).sum()) for a, b in zip(r1[0], dec[0])] == [0, 1, 0]

    store = E1.Encoder.store_deblock_data

    def as_the_decoder(self, binfo):
        bp = binfo.block_param
        if bp.tb_split and bp.mode != 0:
            binfo.block_param = dataclasses.replace(bp, cbp=(1, 1, 1))
        store(self, binfo)
        binfo.block_param = bp

    monkeypatch.setattr(E1.Encoder, "store_deblock_data", as_the_decoder)
    r2 = E1.Encoder(E1.EncoderParams(**d), device="cpu").encode_sequence(
        frames, str(out1))
    assert _same_frames(r2, decode_file(str(out1), device="cpu"))


def test_cli_runs_the_mirror_by_default(tmp_path):
    """python -m thor_tpu_torch.enc without -device_encode is the host
    mirror, as python -m thor_tpu.enc is: the same stream and -rf
    reconstruction from the same command line, whose float parameters
    (a lambda factor, the early-skip threshold) both take as C floats."""
    frames = crop_frames(*CIF, 64, 48, 2)
    yuv = tmp_path / "in.yuv"
    yuv.write_bytes(b"".join(p.tobytes() for f in frames for p in f))
    common = ["-if", str(yuv), "-width", "64", "-height", "48", "-n", "2",
              "-qp", "34", "-max_num_ref", "2", "-lambda_coeffP", "0.83",
              "-early_skip_thr", "0.7"]
    outs = []
    for tag, main, extra in (("a", enc_main0, []),
                             ("b", enc_main1, ["--device", "cpu"])):
        bit, rec = tmp_path / f"{tag}.bit", tmp_path / f"{tag}.yuv"
        assert main(common + ["-of", str(bit), "-rf", str(rec)] + extra) == 0
        outs.append((bit.read_bytes(), rec.read_bytes()))
    assert outs[0] == outs[1]
    dec = decode_file(str(tmp_path / "b.bit"), device="cpu")
    assert outs[1][1] == b"".join(p.tobytes() for f in dec for p in f)
