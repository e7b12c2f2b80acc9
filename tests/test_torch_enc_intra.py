"""The device intra encoder of the port (thor_tpu_torch.enc.device_intra
and kernel 6's plain version, thor_tpu_torch.ops.enc_intra) against
thor_tpu.enc.device_intra on the same seeded numpy inputs: search
references, one search size, split decisions, the tree walk, the scan
records, and the exact scan against the XLA scan and, on a tiny case, the
Pallas kernel in interpret mode; the CUDA kernel against the plain version
on the card.

All data are integers: the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

from thor_tpu_torch.enc import device_intra as DI1
from thor_tpu_torch.ops import enc_intra as EI
from thor_tpu_torch.ops import intra as IT

try:
    import jax.numpy as jnp
    from thor_tpu.dec.native_inputs import (_downleft_available_v,
                                            _upright_available_v)
    from thor_tpu.enc import device_intra as DI0
    from thor_tpu.ops import jax_kernels as JK
    from thor_tpu.ops import pallas_enc_intra as PE
except ImportError:     # a card's machine without JAX runs the gpu tests
    jnp = DI0 = JK = PE = None  # only: pytest --noconftest -m gpu
    _downleft_available_v = _upright_available_v = None


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,W,H", [(8, 48, 40), (16, 64, 48), (4, 24, 20),
                                   (32, 96, 64), (64, 192, 136)])
def test_block_refs_match_jax_and_host(s, W, H):
    rng = np.random.default_rng(s)
    P = rng.integers(0, 256, (H, W)).astype(np.uint8)
    HB, WB = H // s, W // s
    ty = np.repeat(np.arange(HB) * s, WB).astype(np.int32)
    tx = np.tile(np.arange(WB) * s, HB).astype(np.int32)
    # any availability pattern the geometry allows, not only the codec's
    up = (tx + s < W) & (ty > 0) & (rng.random(len(ty)) < 0.6)
    dl = (ty + s < H) & (tx > 0) & (rng.random(len(ty)) < 0.6)
    want = DI0._block_refs_dev(jnp.asarray(P), s, W, H, up, dl)
    got = DI1._block_refs_dev(_t(P), s, W, H, up, dl)
    for g, w_ in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w_))
    if s >= 8:
        # the codec's own availability: also the host function's arrays
        up = _upright_available_v(ty, tx, s, W)
        dl = _downleft_available_v(ty, tx, s, H)
        _, _, top, left, tl, _, _ = DI0._block_refs_host(P, s, W, H)
        got = DI1._block_refs_dev(_t(P), s, W, H, up, dl)
        assert np.array_equal(got[0].numpy(), top)
        assert np.array_equal(got[1].numpy(), left)
        assert np.array_equal(got[2].numpy(), tl)


def _search_frame(rng, W, H):
    """A frame with flat areas (every mode predicts the same there, so
    costs tie and the first mode must win) and textured ones."""
    y = rng.integers(0, 256, (H, W)).astype(np.uint8)
    y[:H // 2, :W // 2] = 90
    y[H // 2:, W // 2:] = (np.arange(W // 2) * 3 % 256).astype(np.uint8)
    u = rng.integers(100, 140, (H // 2, W // 2)).astype(np.uint8)
    u[:H // 4, :W // 4] = 120
    v = np.full((H // 2, W // 2), 128, np.uint8)
    return y, u, v


def test_search_size_matches_jax():
    """One size of the search on a 64x64 frame. lam is a value float32
    cannot hold exactly: both sides must round it the same way and take
    lam * bits in float32."""
    rng = np.random.default_rng(3)
    W = H = 64
    s, nmodes, fast = 16, 10, False
    qpY, qpC, lam = 32, 31, 77.7672
    y, u, v = _search_frame(rng, W, H)
    wm, wc = DI0._search_frame_fn(s, W, H, fast, nmodes)(
        jnp.asarray(y), jnp.asarray(u), jnp.asarray(v), jnp.int32(qpY),
        jnp.int32(qpC), jnp.float32(lam))
    gm, gc = DI1._search_size(
        _t(y), _t(u), _t(v), s, W, H, fast, nmodes, qpY, qpC,
        torch.tensor(lam, dtype=torch.float32))
    assert np.array_equal(gc.numpy(), np.asarray(wc))
    assert np.array_equal(gm.numpy(), np.asarray(wm))
    # a tie: block (0, 0) sees only the frame edge's 128s and block (1, 1)
    # only the flat area, so every mode predicts the same there; modes 2
    # and 3 have the shortest code (2 bits) and the first of them wins
    assert gm[0, 0] == 2 and gm[1, 1] == 2
    assert (gm.numpy() != 2).any()


def _random_maps(rng, W, H):
    return {s: (rng.integers(0, 10, (H // s, W // s)).astype(np.int32),
                rng.integers(0, 5000 * (s // 8) ** 2,
                             (H // s, W // s)).astype(np.int32))
            for s in (8, 16, 32, 64)}


@pytest.mark.parametrize("W,H", [(192, 136), (64, 64), (200, 72)])
def test_split_decisions_and_tree_walk_match(W, H):
    """192x136 has a partial superblock row (136 = 2*64 + 8): the search
    drops it at the larger sizes, the walk forces the split there."""
    rng = np.random.default_rng(W + H)
    host = _random_maps(rng, W, H)
    # equal child and parent costs somewhere: the split needs child < here
    host[16][1][0, 0] = int(host[8][1][:2, :2].sum())
    wm, ws = DI0.intra_split_decisions(host, W, H)
    gm, gs = DI1.intra_split_decisions(host, W, H)
    for s in (16, 32, 64):
        assert np.array_equal(gs[s], ws[s])
    assert not gs[16][0, 0]
    want = DI0._walk_tree(ws, wm, W, H)
    got = DI1._walk_tree(gs, gm, W, H)
    assert got == want
    assert all(y + s <= H and x + s <= W for y, x, s, _ in got)
    covered = sum(s * s for _, _, s, _ in got)
    assert covered == (H // 8) * (W // 8) * 64


# ---------------------------------------------------------------------------
# the exact scan
# ---------------------------------------------------------------------------

def _mk_tus(W, H, rng):
    """Mixed 64/32/8 coding-order TU list (tests/test_pallas_enc_intra.py)
    and thor_tpu's padded record dicts for it."""
    tus = []
    k = 0
    for y0 in range(0, H, 64):
        for x0 in range(0, W, 64):
            pat = k % 3
            k += 1
            if pat == 0:
                tus.append((y0, x0, 64))
            elif pat == 1:
                for (dy, dx) in ((0, 0), (0, 32), (32, 0), (32, 32)):
                    tus.append((y0 + dy, x0 + dx, 32))
            else:
                for (dy, dx) in ((0, 0), (0, 32)):
                    tus.append((y0 + dy, x0 + dx, 32))
                for by in (32, 40, 48, 56):
                    for bx in range(0, 32, 8):
                        tus.append((y0 + by, x0 + bx, 8))
                tus.append((y0 + 32, x0 + 32, 32))
    md = rng.integers(0, 10, len(tus))
    tus = [(t[0], t[1], t[2], int(m)) for t, m in zip(tus, md)]
    ty, tx, sz, md = (np.array([t[i] for t in tus], np.int32)
                      for i in range(4))
    up = _upright_available_v(ty, tx, sz, W)
    dl = _downleft_available_v(ty, tx, sz, H)
    n = len(tus)
    npad = 64
    assert n <= npad

    def padn(a, fill=0):
        return np.concatenate(
            [a.astype(np.int32), np.full(npad - n, fill, np.int32)])

    arr = {
        "ty": padn(ty), "tx": padn(tx), "size": padn(sz, 8),
        "mode": padn(md), "toplen": padn(sz + up, 8),
        "leftlen": padn(sz + dl, 8),
        "cbx_nonzero": padn((tx > 0).astype(np.int32)),
        "valid": padn(np.ones(n, np.int32)),
    }
    arrc = dict(arr)
    arrc["ty"] = padn(ty // 2)
    arrc["tx"] = padn(tx // 2)
    arrc["size"] = padn(sz // 2, 4)
    arrc["toplen"] = padn(sz // 2 + up, 4)
    arrc["leftlen"] = padn(sz // 2 + dl, 4)
    arrc["cbx_nonzero"] = padn((tx // 2 > 0).astype(np.int32))
    return tus, arr, arrc, n, npad


def _pad_for(plane):
    return jnp.pad(jnp.asarray(plane, jnp.int32),
                   ((JK.PADI, JK.PADE), (JK.PADI, JK.PADE)))


def test_scan_records_match_thor_tpu_arrays():
    """The chroma records halve the geometry and keep the luma TU's
    availability flags."""
    rng = np.random.default_rng(1)
    W, H = 192, 128
    tus, arr, arrc, n, _ = _mk_tus(W, H, rng)
    ry, rc = DI1.scan_records(tus, W, H)
    for recs, a in ((ry, arr), (rc, arrc)):
        for col, k in enumerate(IT.FIELDS):
            assert np.array_equal(recs[:, col], a[k][:n]), k


@pytest.mark.parametrize("fast,intra,qp", [
    (False, True, 32), (True, False, 27)])
def test_plain_luma_scan_matches_xla_scan(fast, intra, qp):
    rng = np.random.default_rng(3 * qp)
    W, H = 192, 128
    org = rng.integers(0, 256, (H, W)).astype(np.int32)
    start = rng.integers(0, 256, (H, W)).astype(np.int32)
    tus, arr, _, n, npad = _mk_tus(W, H, rng)
    luma_fn, _ = DI0._encode_scan_fn(fast, npad, intra_quant=intra)
    P, q16, cbp = luma_fn(_pad_for(start), _pad_for(org), arr, jnp.int32(qp))
    want_y = np.asarray(P[JK.PADI:JK.PADI + H, JK.PADI:JK.PADI + W])

    ry, _ = DI1.scan_records(tus, W, H)
    n0 = EI.encode_scan_plain.calls
    got_y, got_q = EI.encode_scan(_t(start)[None], _t(org)[None], _t(ry), qp,
                                  fast, intra)
    assert EI.encode_scan_plain.calls == n0 + 1    # a CPU tensor: plain
    assert np.array_equal(got_y[0].numpy(), want_y)
    assert np.array_equal(got_q[:, 0].numpy(), np.asarray(q16)[:n])
    # cbp is taken before the zero-run pass, which never clears a level
    assert np.array_equal((got_q[:, 0].numpy() != 0).any(axis=(1, 2)),
                          np.asarray(cbp)[:n])


def test_plain_chroma_scan_matches_xla_scan():
    rng = np.random.default_rng(9)
    W, H = 192, 128
    Wc, Hc = W // 2, H // 2
    qp = 35
    org = rng.integers(0, 256, (2, Hc, Wc)).astype(np.int32)
    start = rng.integers(0, 256, (2, Hc, Wc)).astype(np.int32)
    tus, _, arrc, n, npad = _mk_tus(W, H, rng)
    _, chroma_fn = DI0._encode_scan_fn(False, npad, intra_quant=True)
    Pu, Pv, qu, cu, qv, cv = chroma_fn(
        _pad_for(start[0]), _pad_for(start[1]), _pad_for(org[0]),
        _pad_for(org[1]), arrc, jnp.int32(qp))
    _, rc = DI1.scan_records(tus, W, H)
    got_p, got_q = EI.encode_scan(_t(start), _t(org), _t(rc), qp, False, True)
    for c, (Pw, qw, cw) in enumerate(((Pu, qu, cu), (Pv, qv, cv))):
        assert np.array_equal(
            got_p[c].numpy(),
            np.asarray(Pw[JK.PADI:JK.PADI + Hc, JK.PADI:JK.PADI + Wc]))
        assert np.array_equal(got_q[:, c].numpy(), np.asarray(qw)[:n])
        assert np.array_equal((got_q[:, c].numpy() != 0).any(axis=(1, 2)),
                              np.asarray(cw)[:n])


def _random_enc_case(seed, C, H, W, min_s, max_s):
    rng = np.random.default_rng(seed)
    tiles = []

    def split(y, x, s):
        if s > min_s and rng.random() < 0.5:
            h = s // 2
            for dy in (0, h):
                for dx in (0, h):
                    split(y + dy, x + dx, h)
        else:
            tiles.append((y, x, s))

    for y in range(0, H, max_s):
        for x in range(0, W, max_s):
            split(y, x, max_s)
    n = len(tiles)
    ty, tx, s = (np.array([t[i] for t in tiles], np.int32) for i in range(3))
    tus = {"ty": ty, "tx": tx, "size": s,
           "mode": rng.integers(0, 10, n).astype(np.int32),
           "toplen": s + ((tx + s < W) & (rng.random(n) < 0.5)),
           "leftlen": s + ((ty + s < H) & (rng.random(n) < 0.5)),
           "cbx_nonzero": ((tx > 0) & (rng.random(n) < 0.5)).astype(np.int32)}
    planes = rng.integers(0, 256, (C, H, W)).astype(np.int32)
    org = rng.integers(0, 256, (C, H, W)).astype(np.int32)
    return tus, planes, org


def test_plain_scan_matches_pallas_interpret():
    """A tiny chroma pair (sizes 4..16) through the TPU kernel in
    interpret mode, run as tests/test_pallas_enc_intra.py runs it."""
    tus, planes, org = _random_enc_case(5, 2, 32, 32, 4, 16)
    n = len(tus["ty"])
    t = dict(tus, valid=np.ones(n, np.int32))
    recs, cnt = PE.build_enc_records(t, PE.SIZES_C, K=64)
    want_p, want_q = PE.encode_scan_pallas(
        jnp.asarray(planes), jnp.asarray(org), recs, cnt, 30, PE.SIZES_C,
        False, True, interpret=True)
    port_recs = IT.build_intra_records(tus, 32, 32)
    got_p, got_q = EI.encode_scan(_t(planes), _t(org), _t(port_recs), 30,
                                  False, True)
    assert np.array_equal(got_p.numpy(), np.asarray(want_p))
    assert np.array_equal(got_q.numpy(), np.asarray(want_q)[:n])


def test_encode_scan_rejects_what_the_kernel_does_not_take():
    tus, planes, org = _random_enc_case(6, 1, 32, 32, 8, 16)
    with pytest.raises(ValueError):
        IT.build_intra_records(tus, 24, 32)        # a TU outside the plane
    recs = _t(IT.build_intra_records(tus, 32, 32))
    with pytest.raises(ValueError):
        EI.encode_scan(_t(planes).to("meta"), _t(org), recs, 30, False, True)


def _cuda_scan_equals_plain(C, H, W, min_s, max_s, fast, intra, qp):
    tus, planes, org = _random_enc_case(40 + C + 2 * fast + 4 * intra + qp,
                                        C, H, W, min_s, max_s)
    recs = _t(IT.build_intra_records(tus, H, W))
    want_p, want_q = EI.encode_scan_plain(_t(planes), _t(org), recs, qp, fast,
                                          intra)
    dev = torch.device("cuda")
    n0 = EI.encode_scan.launches
    got_p, got_q = EI.encode_scan(_t(planes).to(dev), _t(org).to(dev),
                                  recs.to(dev), qp, fast, intra)
    torch.cuda.synchronize()
    assert EI.encode_scan.launches == n0 + 1
    assert torch.equal(got_p.cpu(), want_p)
    assert torch.equal(got_q.cpu(), want_q)


@pytest.mark.gpu
@pytest.mark.parametrize("C,H,W,min_s,max_s", [(1, 128, 192, 8, 64),
                                               (2, 64, 96, 4, 32)])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("intra", [True, False])
def test_cuda_encode_scan_matches_plain(C, H, W, min_s, max_s, fast, intra):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _cuda_scan_equals_plain(C, H, W, min_s, max_s, fast, intra,
                            24 + 5 * C + fast)


@pytest.mark.gpu
@pytest.mark.parametrize("qp", [0, 11, 51])
def test_cuda_encode_scan_at_the_ends_of_the_qp_range(qp):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _cuda_scan_equals_plain(1, 128, 128, 8, 64, False, True, qp)
    _cuda_scan_equals_plain(2, 64, 64, 4, 32, True, False, qp)
