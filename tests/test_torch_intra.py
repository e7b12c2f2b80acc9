"""Intra scan: the port's plain version (thor_tpu_torch.ops.intra) against
thor_tpu.ops.jax_kernels.intra_scan and, on a tiny case, the Pallas kernel
in interpret mode; the CUDA kernel against the plain version on the card.

Random quadtree intra TU tilings in decode order (the generator style of
tests/test_pallas_intra.py), random modes, availability flags and
residuals. Tolerance: exact equality.
"""

import numpy as np
import pytest
import torch

from thor_tpu_torch.ops import intra as IT

try:
    import jax.numpy as jnp
    from thor_tpu.ops import jax_kernels as JK
    from thor_tpu.ops import pallas_intra as PI
except ImportError:     # a card's machine without JAX runs the gpu tests
    jnp = JK = PI = None  # only: pytest --noconftest -m gpu


def _random_tiling(rng, H, W, min_s, max_s):
    """Random aligned power-of-2 tiling in quadtree decode order."""
    tus = []

    def split(y, x, s):
        if s > min_s and rng.random() < 0.5:
            h = s // 2
            for dy in (0, h):
                for dx in (0, h):
                    split(y + dy, x + dx, h)
        else:
            tus.append((y, x, s))

    for y in range(0, H, max_s):
        for x in range(0, W, max_s):
            split(y, x, max_s)
    return tus


# 128x128 luma tiling in decode order holding every TU size 4..64
LADDER = [(0, 0, 64), (0, 64, 32), (0, 96, 32), (32, 64, 16),
          (32, 80, 16), (48, 64, 8), (48, 72, 8), (56, 64, 4), (56, 68, 4),
          (60, 64, 4), (60, 68, 4), (56, 72, 8), (48, 80, 16),
          (32, 96, 32), (64, 0, 64), (64, 64, 64)]


def _gen(seed, C, H, W, max_s, modes=None, tiles=None):
    rng = np.random.default_rng(seed)
    if tiles is None:
        tiles = _random_tiling(rng, H, W, 4, max_s)
    n = len(tiles)
    ty, tx, size = (np.array([t[i] for t in tiles], np.int32)
                    for i in range(3))
    up = (tx + size < W) & (rng.integers(0, 2, n) == 1)
    dl = (ty + size < H) & (rng.integers(0, 2, n) == 1)
    mode = (rng.integers(0, 11, n) if modes is None
            else rng.choice(modes, n)).astype(np.int32)
    tus = {"ty": ty, "tx": tx, "size": size, "mode": mode,
           "toplen": (size + up).astype(np.int32),
           "leftlen": (size + dl).astype(np.int32),
           "cbx_nonzero": np.where(tx > 0, rng.integers(0, 2, n),
                                   0).astype(np.int32)}
    planes = rng.integers(0, 256, (C, H, W)).astype(np.int32)
    resid = rng.integers(-300, 300, (C, H, W)).astype(np.int32)
    return tus, planes, resid


def _jax_scan(tus, planes, resid):
    C, H, W = planes.shape

    def pad(a):
        return jnp.pad(jnp.asarray(a),
                       ((0, 0), (JK.PADI, JK.PADE), (JK.PADI, JK.PADE)))

    tj = {k: jnp.asarray(v) for k, v in tus.items()}
    tj["valid"] = jnp.ones(len(tus["ty"]), jnp.int32)
    P = JK.intra_scan(pad(planes), pad(resid), tj)
    return np.asarray(P[:, JK.PADI:JK.PADI + H, JK.PADI:JK.PADI + W])


def _port_scan(tus, planes, resid):
    C, H, W = planes.shape
    recs = IT.build_intra_records(tus, H, W)
    return IT.intra_scan(torch.from_numpy(planes), torch.from_numpy(resid),
                         torch.from_numpy(recs)).numpy()


@pytest.mark.parametrize("mode", range(11))
def test_plain_intra_each_mode_luma(mode):
    """One mode at a time over every luma size 4..64 (mode 10 folds to
    DC)."""
    tus, planes, resid = _gen(300 + mode, 1, 128, 128, 64, modes=[mode],
                              tiles=LADDER)
    assert np.array_equal(_port_scan(tus, planes, resid),
                          _jax_scan(tus, planes, resid))


@pytest.mark.parametrize("C,H,W,max_s,seed", [
    (1, 128, 192, 64, 0), (1, 64, 128, 32, 1),
    (2, 64, 96, 32, 2), (2, 64, 64, 32, 3)])
def test_plain_intra_matches_scan(C, H, W, max_s, seed):
    tus, planes, resid = _gen(seed, C, H, W, max_s)
    assert np.array_equal(_port_scan(tus, planes, resid),
                          _jax_scan(tus, planes, resid))


def test_plain_intra_matches_pallas_interpret():
    """A tiny chroma pair through the TPU kernel in interpret mode."""
    tus, planes, resid = _gen(5, 2, 32, 32, 16)
    t = dict(tus, valid=np.ones(len(tus["ty"]), np.int32))
    recs, cnt = PI.build_intra_records(t, PI.SIZES_C, K=64)
    want = np.asarray(PI.intra_scan_pallas(
        jnp.asarray(planes), jnp.asarray(resid), jnp.asarray(recs),
        jnp.asarray(cnt), PI.SIZES_C, interpret=True))
    assert np.array_equal(_port_scan(tus, planes, resid), want)


def test_records_reject_tu_outside_plane():
    tus, _, _ = _gen(0, 1, 64, 64, 32)
    with pytest.raises(ValueError):
        IT.build_intra_records(tus, 60, 64)


@pytest.mark.gpu
@pytest.mark.parametrize("C,H,W,max_s", [(1, 128, 192, 64),
                                         (2, 64, 96, 32)])
def test_cuda_intra_matches_plain(C, H, W, max_s):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tus, planes, resid = _gen(40 + C, C, H, W, max_s)
    recs = torch.from_numpy(IT.build_intra_records(tus, H, W))
    want = IT.intra_scan_plain(torch.from_numpy(planes),
                               torch.from_numpy(resid), recs)
    dev = torch.device("cuda")
    n0 = IT.intra_scan.launches
    got = IT.intra_scan(torch.from_numpy(planes).to(dev),
                        torch.from_numpy(resid).to(dev), recs.to(dev))
    torch.cuda.synchronize()
    assert IT.intra_scan.launches == n0 + 1
    assert torch.equal(got.cpu(), want)
