"""The port's plain tensor ops (thor_tpu_torch.ops.kernels) against their
thor_tpu.ops.jax_kernels counterparts, on the same seeded inputs.

Tolerance: exact equality everywhere; the codec is integer-exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from thor_tpu.dec import reconstruct_jax as RJ
from thor_tpu.ops import jax_kernels as JK
from thor_tpu_torch.dec.inputs import FrameConfig
from thor_tpu_torch.dec.reconstruct import residual_planes
from thor_tpu_torch.ops import kernels as PK

CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_mc_luts_equal():
    for bi in (0, 1):
        assert np.array_equal(PK.build_luma_mc_lut(bi),
                              JK.build_luma_mc_lut(bi))
    assert np.array_equal(PK.build_chroma_mc_lut(), JK.build_chroma_mc_lut())


def test_clip255():
    x = np.random.default_rng(0).integers(-600, 900, (7, 9)).astype(np.int32)
    assert np.array_equal(PK.clip255(_t(x)).numpy(),
                          np.asarray(JK.clip255(jnp.asarray(x))))


@pytest.mark.parametrize("size", [4, 8, 16, 32])
def test_idct_batch_extremes(size):
    """Full int16 coefficient range: the float64 matmul must stay exact."""
    rng = np.random.default_rng(size)
    c = rng.integers(-32768, 32768, (6, size, size)).astype(np.int16)
    c[0] = 32767
    c[1] = -32768
    c[2] = np.where(JK.TMAT[size] >= 0, 32767, -32768).astype(np.int16)
    got = PK.idct_batch(_t(c), size).numpy()
    want = np.asarray(JK.idct_batch(jnp.asarray(c), size))
    assert np.array_equal(got, want)


def _tu_grid(rng, H, W, s, n):
    cells = [(y, x) for y in range(0, H, s) for x in range(0, W, s)]
    pick = rng.choice(len(cells), size=min(n, len(cells)), replace=False)
    ys = np.array([cells[i][0] for i in pick], np.int32)
    xs = np.array([cells[i][1] for i in pick], np.int32)
    return ys, xs


def _dq(rng, n, s):
    qp = rng.integers(0, 52, n)
    tlog2 = 6 if s == 64 else int(np.log2(s))
    f = (np.array([40, 45, 51, 57, 64, 72])[qp % 6] << (qp // 6)) \
        .astype(np.int32)
    sh = np.full(n, tlog2 - 1, np.int32)
    a = (1 << (sh - 1)).astype(np.int32)
    return f, a, sh


@pytest.mark.parametrize("size", [4, 8, 16, 32, 64])
def test_residual_luma_group(size):
    """Sparse densify + dequant + iDCT + scatter for one luma size group
    (64: 32-point iDCT of the low quadrant, 2x2 replication) against the
    JAX stage body reconstruct_jax._resid_y_body."""
    rng = np.random.default_rng(100 + size)
    H, W = 128, 192
    ys, xs = _tu_grid(rng, H, W, size, 12)
    n, cs = len(ys), (32 if size == 64 else size)
    coeff = np.where(rng.random((n, cs, cs)) < 0.2,
                     rng.integers(-300, 300, (n, cs, cs)), 0) \
        .astype(np.int16)
    f, a, sh = _dq(rng, n, size)
    want = np.asarray(RJ._resid_y_body(
        size, jnp.zeros((H, W), jnp.int32), jnp.asarray(coeff),
        jnp.asarray(f), jnp.asarray(a), jnp.asarray(sh), jnp.asarray(ys),
        jnp.asarray(xs)))
    flat = coeff.reshape(-1)
    nz = np.flatnonzero(flat)
    g = {"cidx": _t(nz.astype(np.int64)), "cval": _t(flat[nz].astype(
        np.int32)), "y": _t(ys), "x": _t(xs), "f": _t(f), "a": _t(a),
         "sh": _t(sh)}
    cfg = FrameConfig(W=W, H=H, R=0, deblocking=False, clpf=False)
    ry, rc = residual_planes(cfg, {f"gy{size}": g}, CPU)
    assert np.array_equal(ry.numpy(), want)
    assert not rc.any()


@pytest.mark.parametrize("size", [4, 8, 16, 32])
def test_residual_chroma_group(size):
    rng = np.random.default_rng(200 + size)
    Hc, Wc = 64, 96
    ys, xs = _tu_grid(rng, Hc, Wc, size, 10)
    n = len(ys)
    pl = rng.integers(0, 2, n).astype(np.int32)
    coeff = rng.integers(-200, 200, (n, size, size)).astype(np.int16)
    f, a, sh = _dq(rng, n, size)
    want = np.asarray(RJ._resid_c_body(
        size, jnp.zeros((2, Hc, Wc), jnp.int32), jnp.asarray(coeff),
        jnp.asarray(f), jnp.asarray(a), jnp.asarray(sh), jnp.asarray(ys),
        jnp.asarray(xs), jnp.asarray(pl)))
    vals = PK.residual_group(_t(coeff), _t(f), _t(a), _t(sh), size)
    got = PK.scatter_tu_c(torch.zeros((2, Hc, Wc), dtype=torch.int32),
                          vals, _t(ys), _t(xs), _t(pl))
    assert np.array_equal(got.numpy(), want)


def _random_dd(rng, H, W):
    gh, gw = H // 4, W // 4
    size = rng.choice([8, 16, 32, 64], (gh, gw))
    mv = {k: rng.integers(-9, 10, (gh, gw)) for k in
          ("mv0x", "mv0y", "mv1x", "mv1y")}
    return dict(size=size, tb_split=rng.integers(0, 2, (gh, gw)),
                pb_part=rng.integers(0, 4, (gh, gw)),
                mode=rng.integers(0, 5, (gh, gw)),
                cbp_y=rng.integers(0, 2, (gh, gw)), **mv)


def test_pack_unpack_ddp():
    dd = _random_dd(np.random.default_rng(1), 64, 96)
    p = PK.pack_ddp(dd)
    assert np.array_equal(p, JK.pack_ddp(dd))
    got = PK.unpack_ddp(_t(p))
    want = JK.unpack_ddp(jnp.asarray(p))
    for k in want:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k


@pytest.mark.parametrize("seed", [0, 1])
def test_deblock_luma_and_chroma(seed):
    """Random planes and side info; beta/tc large enough that most edges
    filter."""
    rng = np.random.default_rng(seed)
    H, W = 64, 96
    ddp = PK.pack_ddp(_random_dd(rng, H, W))
    y = rng.integers(0, 256, (H, W)).astype(np.int32)
    y = (y // 32 * 32 + rng.integers(0, 6, (H, W))).astype(np.int32)
    u = rng.integers(0, 256, (H // 2, W // 2)).astype(np.int32)
    beta, tc, tcC = 40 + seed, 6, 4
    ddj = JK.unpack_ddp(jnp.asarray(ddp))
    ddt = PK.unpack_ddp(_t(ddp))
    want_y = np.asarray(JK.deblock_luma(jnp.asarray(y), ddj, H, W,
                                        jnp.int32(beta), jnp.int32(tc)))
    want_u = np.asarray(JK.deblock_chroma(jnp.asarray(u), ddj, H, W,
                                          jnp.int32(tcC)))
    got_y = PK.deblock_luma(_t(y), ddt, H, W, beta, tc).numpy()
    got_u = PK.deblock_chroma(_t(u), ddt, H, W, tcC).numpy()
    assert (want_y != y).any() and (want_u != u).any()
    assert np.array_equal(got_y, want_y)
    assert np.array_equal(got_u, want_u)


@pytest.mark.parametrize("plane", ["luma", "chroma"])
def test_clpf_plane(plane):
    rng = np.random.default_rng(7)
    H, W, ds, bs = (72, 136, 64, 8) if plane == "luma" else (36, 68, 32, 4)
    x = rng.integers(0, 256, (H, W)).astype(np.int32)
    x = (x // 3 * 3).astype(np.int32)
    m = rng.random((H // bs, W // bs)) < 0.6
    want = np.asarray(JK.clpf_plane(jnp.asarray(x), jnp.asarray(m), ds, H,
                                    W))
    got = PK.clpf_plane(_t(x), _t(m), ds, H, W).numpy()
    assert (want != x).any()
    assert np.array_equal(got, want)


def test_edge_pad():
    x = np.random.default_rng(3).integers(0, 256, (10, 14)).astype(np.uint8)
    assert np.array_equal(PK.edge_pad(_t(x), 5).numpy(),
                          np.pad(x, 5, mode="edge"))
