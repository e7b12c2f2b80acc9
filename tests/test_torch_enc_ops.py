"""Encoder ops of the port (thor_tpu_torch.ops.kernels, ops.coeff_bits,
the batched intra predictor) against thor_tpu's XLA forms on the same
seeded numpy inputs, and the port's host writers against thor_tpu's.

All data are integers: the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from thor_tpu.bitstream import writer as W0
from thor_tpu.codec import blockdata as B0
from thor_tpu.codec.constants import zigzag_for
from thor_tpu.enc import block as BL0
from thor_tpu.enc import syntax as S0
from thor_tpu.enc.device_intra import _recon_from_q
from thor_tpu.ops import coeff_bits as CB0
from thor_tpu.ops import jax_kernels as JK

from thor_tpu_torch.bitstream import writer as W1
from thor_tpu_torch.codec import blockdata as B1
from thor_tpu_torch.enc import block as BL1
from thor_tpu_torch.enc import syntax as S1
from thor_tpu_torch.ops import coeff_bits as CB1
from thor_tpu_torch.ops import intra as IT
from thor_tpu_torch.ops import kernels as K


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# forward transform
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("fast", [False, True])
def test_fwd_transform_matches_jax(size, fast):
    """Pixel-range residuals, and inputs large enough that both stages
    wrap around int16 (the reference stores each stage as int16_t)."""
    rng = np.random.default_rng(size + fast)
    small = rng.integers(-255, 256, (6, size, size)).astype(np.int32)
    big = rng.integers(-6000, 6001, (6, size, size)).astype(np.int32)
    flat = np.full((1, size, size), 255, np.int32)
    x = np.concatenate([small, big, flat, -flat])
    want = np.asarray(JK.fwd_transform_batch(jnp.asarray(x), size, fast))
    got = K.fwd_transform_batch(_t(x), size, fast).numpy()
    assert np.array_equal(got, want)
    exact = np.asarray(JK.fwd_transform_batch(
        jnp.asarray(big).astype(jnp.int32), size, fast)).astype(np.int64)
    assert np.abs(exact).max() <= 32768      # int16-valued after the wrap


def test_wrap16_wraps_and_idct_saturates():
    x = torch.tensor([32767, 32768, 40000, -32768, -32769, 65536 + 5])
    assert K._wrap16(x).tolist() == [32767, -32768, -25536, -32768, 32767, 5]
    # the inverse side clamps: a level far above the int16 range
    q = torch.zeros((1, 8, 8), dtype=torch.int32)
    q[0, 0, 0] = 30000
    pred = torch.zeros((1, 8, 8), dtype=torch.int32)
    want = np.asarray(_recon_from_q(jnp.zeros((1, 8, 8), jnp.int32),
                                    jnp.asarray(q.numpy()), 8, 40))
    assert np.array_equal(K.recon_from_q(pred, q, 8, 40).numpy(), want)


# ---------------------------------------------------------------------------
# forward quantizer and its zero-run pass
# ---------------------------------------------------------------------------

def _trigger_blocks(rng, size, qp, n):
    """Scan-order coefficient blocks built to fire the zero-run pass: a
    level above 1 after two zeros, with the three raw magnitudes ordered
    so that each of the three moves (current, one back, two back) is
    taken, and levels 3 / 4 back that veto it."""
    qs = min(size, 16)
    Nc = qs * qs
    step = max(1, (1 << (21 - int(np.log2(size)) + qp // 6))
               // int([26214, 23302, 20560, 18396, 16384, 14564][qp % 6]))
    sco = np.zeros((n, Nc), np.int32)
    for b in range(n):
        p = 2
        while p < Nc - 1:
            p += int(rng.integers(2, 7))
            if p >= Nc:
                break
            kind = int(rng.integers(0, 5))
            sco[b, p] = int(rng.choice([-1, 1])) * step * int(
                rng.integers(2, 5))
            lo = max(1, step // 8)
            if kind == 0:                  # all tiny: move the current
                sco[b, p] = int(rng.choice([-1, 1])) * (2 * step + 1)
                sco[b, p - 1] = int(rng.integers(-lo, lo + 1))
            elif kind == 1:                # one back is the larger
                sco[b, p - 1] = int(rng.choice([-1, 1])) * (step // 2)
                sco[b, p - 2] = int(rng.integers(-lo, lo + 1))
            elif kind == 2:                # two back is the larger
                sco[b, p - 2] = int(rng.choice([-1, 1])) * (step // 2)
                sco[b, p - 1] = int(rng.integers(-lo, lo + 1))
            elif kind == 3 and p >= 3:     # veto by a big level 3 back
                sco[b, p - 3] = 3 * step
            # kind 4: leave as is
    zz = np.asarray(zigzag_for(qs))
    blk = np.zeros((n, size, size), np.int32)
    blk[:, :qs, :qs] = sco[:, zz].reshape(n, qs, qs)
    return blk


@pytest.mark.parametrize("size,qp", [(4, 30), (8, 35), (8, 24), (16, 29),
                                     (32, 32), (64, 41), (8, 0), (16, 51)])
@pytest.mark.parametrize("intra", [True, False])
@pytest.mark.parametrize("chroma", [False, True])
def test_quantize_matches_jax(size, qp, intra, chroma):
    """qp % 6 covers 0 (30, 24) and 5 (35, 29, 41); qp 0 and 51 are the
    ends of the range."""
    rng = np.random.default_rng(size * 100 + qp + 2 * intra + chroma)
    qs = min(size, 16)
    zz = zigzag_for(qs)
    rnd = np.zeros((24, size, size), np.int32)
    rnd[:, :qs, :qs] = (rng.laplace(0, 60, (24, qs, qs))).astype(np.int32)
    rnd[0] = 0                                        # cbp 0
    rnd[1, 0, 0] = -32768                             # int16 extremes
    coeff = np.concatenate([rnd, _trigger_blocks(rng, size, qp, 40)])
    wq, wc = JK.quantize_fwd_batch(jnp.asarray(coeff), qp, size, intra, zz,
                                   chroma)
    gq, gc = K.quantize_fwd_batch(_t(coeff), qp, size, intra, zz, chroma)
    assert np.array_equal(gq.numpy(), np.asarray(wq))
    assert np.array_equal(gc.numpy(), np.asarray(wc))
    # cbp is taken before the zero-run pass; the pass writes +-1, never 0
    assert np.array_equal(gc.numpy(), (gq.numpy() != 0).any(axis=(1, 2)))


def test_zero_run_pass_takes_all_three_moves():
    """The trigger blocks really reach each move: the pass changes the
    current, the previous and the one before that position somewhere."""
    rng = np.random.default_rng(5)
    size, qp = 8, 35
    coeff = _t(_trigger_blocks(rng, size, qp, 200))
    zz = torch.as_tensor(np.asarray(zigzag_for(8)), dtype=torch.long)
    sco = torch.zeros((200, 64), dtype=torch.int32)
    sco[:, zz] = coeff.reshape(200, 64)
    shift2 = 21 - 3 + qp // 6
    scale = 14564
    absc = scale * sco.abs()
    off0, off1 = 102 << (shift2 - 8), 115 << (shift2 - 8)
    level = (absc + torch.where((absc >> shift2) == 0, off0, off1)) >> shift2
    last = torch.where(((absc + (38 << (shift2 - 8))) >> shift2) != 0,
                       torch.arange(64, dtype=torch.int32)[None], -1).amax(1)
    q0 = torch.where(torch.arange(64)[None] <= last[:, None],
                     ((sco >> 31) | 1) * level, 0).to(torch.int32)
    q1 = K._rdoq_light(q0, sco, last, qp, 3, 64, False)
    ch = q0 != q1
    assert ch.any()
    was0 = ch & (q0 == 0)          # a zero became +-1: one or two back
    lowered = ch & (q0 != 0)       # the current level dropped to +-1
    assert was0.any() and lowered.any()
    assert (q1[ch].abs() == 1).all()
    nxt = torch.nn.functional.pad(q0.abs(), (0, 2))
    assert (was0 & (nxt[:, 1:65] > 1)).any()      # one back
    assert (was0 & (nxt[:, 1:65] == 0) & (nxt[:, 2:66] > 1)).any()


# ---------------------------------------------------------------------------
# coefficient bit cost
# ---------------------------------------------------------------------------

def _coeff_blocks(size, intra, chroma):
    """The blocks of tests/test_coeff_bits.py."""
    rng = np.random.default_rng(size * 4 + intra * 2 + chroma)
    qs = min(size, 16)
    blocks = []
    for _ in range(100):
        b = np.zeros((size, size), np.int16)
        k = rng.integers(1, 24)
        ys = rng.integers(0, qs, k)
        xs = rng.integers(0, qs, k)
        b[ys, xs] = rng.choice(
            [-60, -9, -4, -3, -2, -1, 1, 2, 3, 4, 9, 60], k)
        if not b[:qs, :qs].any():
            b[0, 0] = 1
        blocks.append(b)
    dense = rng.integers(-5, 6, (size, size)).astype(np.int16)
    if not dense[:qs, :qs].any():
        dense[0, 0] = 1
    blocks.append(dense)
    for v in (1, -1, 2, -2):
        b = np.zeros((size, size), np.int16)
        b[0, 0] = v
        blocks.append(b)
    return np.stack(blocks)


@pytest.mark.parametrize("size", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("intra", [0, 1])
@pytest.mark.parametrize("chroma", [0, 1])
def test_coeff_bits_matches_jax_and_write_coeff(size, intra, chroma):
    blocks = _coeff_blocks(size, intra, chroma)
    got = CB1.coeff_bits_batch(_t(blocks), size, bool(intra),
                               bool(chroma)).numpy()
    want = np.asarray(CB0.coeff_bits_batch(blocks, size, bool(intra),
                                           bool(chroma)))
    assert np.array_equal(got, want)
    for i, b in enumerate(blocks):
        w = W1.BitWriter()
        S1.write_coeff(w, b, size, (intra << 1) | chroma)
        assert w.get_bit_pos() == got[i], (size, intra, chroma, i)


def test_flog2_at_powers_of_two():
    v = np.array([1, 2, 3] + [x for k in range(2, 24)
                              for x in ((1 << k) - 1, 1 << k, (1 << k) + 1)],
                 np.int32)
    want = np.array([int(x).bit_length() - 1 for x in v], np.int32)
    assert np.array_equal(CB1._flog2(_t(v)).numpy(), want)
    assert np.array_equal(np.asarray(CB0._flog2(jnp.asarray(v))), want)


# ---------------------------------------------------------------------------
# batched intra prediction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", range(10))
def test_batched_predict_matches_intra_predict_s(mode):
    rng = np.random.default_rng(70 + mode)
    n = 12
    for s in (4, 8, 16, 32, 64):
        left = rng.integers(0, 256, (n, 128)).astype(np.int32)
        top = rng.integers(0, 256, (n, 128)).astype(np.int32)
        tl = rng.integers(0, 256, n).astype(np.int32)
        ty = (rng.integers(0, 3, n) * s).astype(np.int32)
        tx = (rng.integers(0, 3, n) * s).astype(np.int32)
        want = np.asarray(jax.vmap(
            lambda L, T, t, y, x: JK.intra_predict_s(L, T, t, y, x, s, mode))(
            jnp.asarray(left), jnp.asarray(top), jnp.asarray(tl),
            jnp.asarray(ty), jnp.asarray(tx)))
        got = IT._predict(_t(left), _t(top), _t(tl), _t(ty), _t(tx), s,
                          mode).numpy()
        assert np.array_equal(got, want), s


# ---------------------------------------------------------------------------
# host writers
# ---------------------------------------------------------------------------

def test_bitwriter_and_vlc_tables_match():
    rng = np.random.default_rng(11)
    w0, w1 = W0.BitWriter(), W1.BitWriter()
    for _ in range(2000):
        n = int(rng.integers(1, 33))
        v = int(rng.integers(0, 1 << 32))
        w0.putbits(n, v)
        w1.putbits(n, v)
    for table in range(14):
        hi = {6: 100, 7: 200, 8: 3, 11: 50, 12: 5, 13: 7}.get(table, 300)
        for cn in range(hi):
            assert W0.put_vlc(table, cn, w0) == W1.put_vlc(table, cn, w1)
            assert W0.quote_vlc(table, cn) == W1.quote_vlc(table, cn)
    pos = w1.save()
    w1.putbits(7, 5)
    w1.restore(pos)
    assert w0.get_bit_pos() == w1.get_bit_pos()
    assert w0.flush_frame() == w1.flush_frame()


class _Ectx:
    """The encoder fields the writers read."""

    def __init__(self, frame_type, num_intra_modes, max_delta_qp):
        self.frame_type = frame_type
        self.num_intra_modes = num_intra_modes
        self.max_delta_qp = max_delta_qp
        self.num_ref = 1
        self.interp_ref = 0
        self.enable_bipred = 0


@pytest.mark.parametrize("nmodes,max_delta_qp,contexts", [
    (10, 0, False), (4, 1, True), (8, 0, True)])
def test_intra_block_syntax_matches(nmodes, max_delta_qp, contexts):
    """write_super_mode / write_delta_qp / write_block on seeded intra
    blocks, with block contexts read from an equal side-info map."""
    rng = np.random.default_rng(nmodes)
    H = W = 128
    dd0, dd1 = B0.DeblockData(W, H), B1.DeblockData(W, H)
    w0, w1 = W0.BitWriter(), W1.BitWriter()
    e = _Ectx(0, nmodes, max_delta_qp)
    for y0, x0, s in [(0, 0, 64), (0, 64, 32), (0, 96, 32), (32, 64, 16),
                      (32, 80, 8), (32, 88, 8), (40, 80, 8), (40, 88, 8),
                      (48, 64, 16), (48, 80, 16), (32, 96, 32), (64, 0, 64),
                      (64, 64, 32), (64, 96, 16)]:
        sc = s // 2
        qs, qsc = min(s, 16), min(sc, 16)
        cy = np.zeros((s, s), np.int16)
        cu = np.zeros((sc, sc), np.int16)
        cv = np.zeros((sc, sc), np.int16)
        cy[:qs, :qs] = rng.integers(-3, 4, (qs, qs)) * (rng.random(
            (qs, qs)) < 0.2)
        cu[:qsc, :qsc] = rng.integers(-2, 3, (qsc, qsc)) * (rng.random(
            (qsc, qsc)) < 0.2)
        cv[0, 0] = int(rng.integers(-1, 2))
        cbp = (int(cy.any()), int(cu.any()), int(cv.any()))
        # the 8-mode table has no code for modes 1 and 5
        mode = int(rng.choice([m for m in range(nmodes)
                               if nmodes != 8 or m not in (1, 5)]))
        dq = int(rng.integers(-2, 3))
        for (Wm, Bm, BLm, Sm, w, dd) in ((W0, B0, BL0, S0, w0, dd0),
                                         (W1, B1, BL1, S1, w1, dd1)):
            bi = BLm.BlockInfo(size=s, ypos=y0, xpos=x0, bwidth=s,
                               bheight=s)
            bi.block_context = Bm.find_block_contexts(
                y0, x0, H, W, s, dd, contexts)
            if s < 64:
                Sm.write_super_mode(w, e, bi, 1, 0, 1)
            if max_delta_qp:
                Sm.write_delta_qp(w, dq)
            bp = BLm.BlockParam(mode=1, intra_mode=mode, cbp=cbp,
                                coeff_y=cy, coeff_u=cu, coeff_v=cv)
            Sm.write_block(w, e, bi, bp)
            dd.store_block(y0, x0, s, s, s, 1, cbp, 0, 0, bp.mv_arr0,
                           bp.mv_arr1, 0, 0, 0)
    assert w0.get_bit_pos() == w1.get_bit_pos()
    assert w0.flush_frame() == w1.flush_frame()
    for k in ("mode", "size", "cbp_y", "cbp_u", "cbp_v"):
        assert np.array_equal(getattr(dd0, k), getattr(dd1, k))
