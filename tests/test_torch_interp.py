"""Temporal interpolation: the port's plain versions
(thor_tpu_torch.ops.interp) against thor_tpu's XLA forms
(ops/device_interp), its Pallas kernels in interpret mode
(ops/pallas_interp) and its numpy oracle (ops/temporal_interp); the CUDA
kernels against the plain versions on the card.

Inputs are seeded numpy arrays handed to both sides, in the style of
tests/test_pallas_interp.py. Tolerance: exact equality (integer data).
"""

import numpy as np
import pytest
import torch

from thor_tpu_torch.ops import interp as TI

try:
    import jax.numpy as jnp
    from thor_tpu.ops import device_interp as DI
    from thor_tpu.ops import pallas_interp as PI
    from thor_tpu.ops import temporal_interp as NPI
except ImportError:     # a card's machine without JAX runs the gpu tests
    jnp = DI = PI = NPI = None  # only: pytest --noconftest -m gpu


class _Ref:
    def __init__(self, y, u, v):
        self.y, self.u, self.v = y, u, v

    def to(self, dev):
        return _Ref(*(torch.from_numpy(p).to(dev)
                      for p in (self.y, self.u, self.v)))


def _mk_refs(rng, w, h, shift):
    """Two correlated codec-padded frames (ref1 = shifted ref0 + noise)."""
    base = rng.integers(0, 256, (h + 64, w + 64), np.uint8)
    y0 = base[32:32 + h, 32:32 + w]
    y1 = base[32 + shift[0]:32 + shift[0] + h,
              32 + shift[1]:32 + shift[1] + w].copy()
    n = rng.integers(-4, 5, y1.shape)
    y1 = np.clip(y1.astype(np.int32) + n, 0, 255).astype(np.uint8)

    def mk(y):
        u = y[::2, ::2].copy()
        v = 255 - u
        return _Ref(np.pad(y, 96, mode="edge"), np.pad(u, 48, mode="edge"),
                    np.pad(v, 48, mode="edge"))
    return mk(y0), mk(y1)


def _me_case(seed, w, h, pad, guided, gmax=6):
    """Two correlated padded planes and a guide field, so that both the
    skip and the search paths run."""
    rng = np.random.default_rng(seed)
    bw, bh = TI.me_grid(w, h)
    p0 = rng.integers(0, 256, (h + 2 * pad, w + 2 * pad), np.uint8)
    p1 = rng.integers(0, 256, (h + 2 * pad, w + 2 * pad), np.uint8)
    p1[pad:pad + h, pad:pad + w] = np.clip(
        p0[pad - 1:pad - 1 + h, pad + 1:pad + 1 + w].astype(np.int32)
        + rng.integers(-3, 4, (h, w)), 0, 255).astype(np.uint8)
    g = (rng.integers(-gmax, gmax + 1, (bh, bw, 2)) * 8).astype(np.int32) \
        if guided else np.zeros((bh, bw, 2), np.int32)
    return p0, p1, g, bw, bh


def _port_me(p0, p1, g, wts, w, h, pad, guided, dev="cpu"):
    out = TI.me_level(
        torch.from_numpy(p0).to(dev), torch.from_numpy(p1).to(dev),
        torch.from_numpy(g[:, :, 0].copy()).to(dev),
        torch.from_numpy(g[:, :, 1].copy()).to(dev), wts,
        w=w, h=h, pad=pad, guided=guided)
    return [o.cpu().numpy() for o in out]


def _jax_me(p0, p1, g, wts, w, h, pad, guided):
    bw, bh = TI.me_grid(w, h)
    mv0, mv1, bg, _, _ = DI._me_level_fn(w, h, pad, guided)(
        jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(g.reshape(-1, 2)),
        jnp.int32(wts[0]), jnp.int32(wts[1]))
    mv0 = np.asarray(mv0).reshape(bh, bw, 2)
    mv1 = np.asarray(mv1).reshape(bh, bw, 2)
    return [mv0[:, :, 0], mv0[:, :, 1], mv1[:, :, 0], mv1[:, :, 1],
            np.asarray(bg).reshape(bh, bw)]


def _same(got, want):
    for name, a, b in zip(("mv0x", "mv0y", "mv1x", "mv1y", "bg"), got, want):
        assert np.array_equal(a, b), \
            f"{name} differs at {np.argwhere(a != b)[:5]}"


# ---------------------------------------------------------------------------
# plain versions against thor_tpu (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wts", [(3, 1), (1, 1), (7, 9)])
@pytest.mark.parametrize("guided", [False, True])
def test_me_level_plain_matches_device_interp(guided, wts):
    w, h, pad = 64, 48, 32
    p0, p1, g, _, _ = _me_case(4 + guided, w, h, pad, guided)
    n0 = TI.me_level_plain.calls
    got = _port_me(p0, p1, g, wts, w, h, pad, guided)
    assert TI.me_level_plain.calls == n0 + 1      # CPU tensor: plain version
    _same(got, _jax_me(p0, p1, g, wts, w, h, pad, guided))


@pytest.mark.parametrize("w,h,gmax", [(56, 40, 60), (16, 48, 6)])
def test_me_level_plain_edges(w, h, gmax):
    """56x40: guide vectors up to 60 pels with a 32-pel pad on a level
    that is not a whole number of blocks, so windows are clipped pixel by
    pixel, the skip test's inside checks fail, and the last block row and
    column hang over the frame. 16x48: one block column, where the
    up-right neighbour's index is clamped onto the up neighbour and the
    first-column rate term reads it."""
    pad = 32
    p0, p1, g, _, _ = _me_case(11, w, h, pad, True, gmax=gmax)
    _same(_port_me(p0, p1, g, (5, 3), w, h, pad, True),
          _jax_me(p0, p1, g, (5, 3), w, h, pad, True))


def test_me_level_plain_matches_pallas_interpret():
    """A tiny guided case through the TPU kernel in interpret mode."""
    w, h, pad = 32, 32, 32
    p0, p1, g, bw, bh = _me_case(21, w, h, pad, True)
    want = PI.me_level_pallas(
        jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(g[:, :, 0]),
        jnp.asarray(g[:, :, 1]), jnp.asarray([3, 1], jnp.int32),
        w=w, h=h, pad=pad, bw=bw, bh=bh, guided=True, interpret=True)
    _same(_port_me(p0, p1, g, (3, 1), w, h, pad, True),
          [np.asarray(o) for o in want])


def _mc_case(seed, w, h, cs, base, reach):
    """Padded planes and cell vectors reaching `reach` pels, past the
    clip halo, so that the one-window cases and the pixel clip run."""
    rng = np.random.default_rng(seed)
    bw, bh = -(-w // cs), -(-h // cs) + 1       # a grid larger than the plane
    planes = [rng.integers(0, 256, (h + 2 * base, w + 2 * base), np.uint8)
              for _ in range(4)]
    mv0 = rng.integers(-reach * 8, reach * 8 + 1, (bh, bw, 2)).astype(np.int32)
    mv1 = rng.integers(-reach * 8, reach * 8 + 1, (bh, bw, 2)).astype(np.int32)
    mv0[::3, ::2] //= 16                         # keep some windows inside
    mv1[::2, ::3] //= 16
    return planes, mv0, mv1


def test_mot_comp_plain_matches_pallas_interpret():
    w, h, cs, base = 48, 32, 8, 96
    planes, mv0, mv1 = _mc_case(31, w, h, cs, base, 20)
    kw = dict(w=w, h=h, cs=cs, clip_pad=4, base=base)
    n0 = TI.mot_comp_plain.calls
    got = TI.mot_comp(*(torch.from_numpy(a) for a in
                        (planes[0], planes[1], mv0, mv1)), **kw).numpy()
    assert TI.mot_comp_plain.calls == n0 + 1
    want = np.asarray(PI.mot_comp_pallas(
        *(jnp.asarray(a) for a in (planes[0], planes[1], mv0, mv1)),
        interpret=True, **kw))
    assert got.shape == (h, w) and got.dtype == np.uint8
    assert np.array_equal(got, want)


def test_mot_comp_uv_plain_matches_pallas_interpret():
    w, h, cs, base = 24, 16, 4, 48
    planes, mv0, mv1 = _mc_case(32, w, h, cs, base, 12)
    kw = dict(w=w, h=h, cs=cs, clip_pad=2, base=base)
    n0 = TI.mot_comp_uv_plain.calls
    u, v = TI.mot_comp_uv(*(torch.from_numpy(a) for a in
                            (*planes, mv0, mv1)), **kw)
    assert TI.mot_comp_uv_plain.calls == n0 + 1
    wu, wv = PI.mot_comp_pallas_uv(*(jnp.asarray(a) for a in
                                     (*planes, mv0, mv1)),
                                   interpret=True, **kw)
    assert np.array_equal(u.numpy(), np.asarray(wu))
    assert np.array_equal(v.numpy(), np.asarray(wv))


@pytest.mark.parametrize("w,h,pad_in", [(64, 48, 96), (45, 33, 32)])
def test_downscale2x2_matches(w, h, pad_in):
    """Also an odd width and height: the last row and column drop."""
    rng = np.random.default_rng(w)
    yp = rng.integers(0, 256, (h + 2 * pad_in, w + 2 * pad_in), np.uint8)
    got = TI.downscale2x2(torch.from_numpy(yp), pad_in, w, h, TI.PAD_L)
    want = np.asarray(DI.downscale2x2(jnp.asarray(yp), pad_in, w, h,
                                      DI.PAD_L))
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)


def test_upscale_mv_matches():
    """2x MV upscale onto a grid that is not twice the coarse one."""
    rng = np.random.default_rng(5)
    bwi, bhi, bwo, bho = 6, 4, 12, 10
    m = rng.integers(-50, 51, (bhi, bwi, 2)).astype(np.int32)
    want = np.asarray(DI._upscale_fn(bwi, bhi, bwo, bho)(
        jnp.asarray(m.reshape(-1, 2)))).reshape(bho, bwo, 2)
    for k in range(2):
        got = TI.upscale_mv(torch.from_numpy(m[:, :, k].copy()), bwo, bho)
        assert np.array_equal(got.numpy(), want[:, :, k])


def test_constants_and_levels_match():
    for k in ("BLOCK_STEP", "COST_MAX", "LAMBDA", "LAMBDA_SHIFT",
              "SKIP_THRESHOLD", "ACC_BITS", "ACC_ROUND", "MAX_LEVELS",
              "PAD_L"):
        assert getattr(TI, k) == getattr(DI, k), k
    assert [TI.num_levels(w, h) for w, h in
            ((1920, 1080), (352, 288), (176, 144), (64, 64))] == [4, 4, 3, 2]


@pytest.mark.parametrize("ratio,pos", [(2, 1), (4, 1), (4, 3), (8, 3)])
def test_pyramid_matches_device_interp_and_oracle(ratio, pos):
    """The whole synthesis at 176x144 (three levels) against thor_tpu's
    device pyramid and its numpy oracle; (4, 3) takes the reversed path,
    (4, 1) and (8, 3) unequal weights."""
    rng = np.random.default_rng(40 + ratio + pos)
    w, h = 176, 144
    r0, r1 = _mk_refs(rng, w, h, (1, 2))
    got = TI.interpolate_frames(r0.to("cpu"), r1.to("cpu"), ratio, pos)
    want = DI.interpolate_frames_device(r0, r1, ratio, pos)
    for name, g, wv in zip(("y", "u", "v", "yp", "up", "vp"), got, want):
        assert np.array_equal(g.numpy(), np.asarray(wv)), name
    oracle = NPI.interpolate_frames(r0, r1, ratio, pos, native=False)
    for name, g, o in zip("yuv", got[:3], oracle):
        assert np.array_equal(g.numpy(), np.asarray(o)), name


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a card raises."""
    t = torch.zeros((80, 80), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        TI.me_level(t, t, None, None, (1, 1), w=16, h=16, pad=32,
                    guided=False)
    m = torch.zeros((2, 2, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        TI.mot_comp(t, t, m, m, w=16, h=16, cs=8, clip_pad=4, base=32)


# ---------------------------------------------------------------------------
# CUDA kernels against the plain versions (on the card)
# ---------------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    (64, 48, 32, False, 6, (3, 1)), (64, 48, 32, True, 6, (3, 1)),
    (56, 40, 32, True, 60, (5, 3)), (352, 288, 96, True, 4, (1, 1)),
    (44, 36, 32, False, 0, (7, 9)), (16, 16, 32, True, 8, (2, 1))])
def test_cuda_me_level_matches_plain(case):
    dev = _cuda()
    w, h, pad, guided, gmax, wts = case
    p0, p1, g, _, _ = _me_case(50 + w, w, h, pad, guided, gmax=max(gmax, 1))
    want = _port_me(p0, p1, g, wts, w, h, pad, guided)
    n0 = TI.me_level.launches
    got = _port_me(p0, p1, g, wts, w, h, pad, guided, dev=dev)
    torch.cuda.synchronize()
    assert TI.me_level.launches == n0 + 1
    _same(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("plane", ["luma", "chroma"])
def test_cuda_mot_comp_matches_plain(plane):
    dev = _cuda()
    if plane == "luma":
        w, h, cs, base, clip = 120, 72, 8, 96, 4
    else:
        w, h, cs, base, clip = 60, 36, 4, 48, 2
    planes, mv0, mv1 = _mc_case(61, w, h, cs, base, 24)
    kw = dict(w=w, h=h, cs=cs, clip_pad=clip, base=base)
    cpu = [torch.from_numpy(a) for a in (*planes, mv0, mv1)]
    gpu = [t.to(dev) for t in cpu]
    if plane == "luma":
        want = [TI.mot_comp_plain(cpu[0], cpu[1], cpu[4], cpu[5], **kw)]
        n0 = TI.mot_comp.launches
        got = [TI.mot_comp(gpu[0], gpu[1], gpu[4], gpu[5], **kw)]
        assert TI.mot_comp.launches == n0 + 1
    else:
        want = TI.mot_comp_uv_plain(*cpu, **kw)
        n0 = TI.mot_comp_uv.launches
        got = TI.mot_comp_uv(*gpu, **kw)
        assert TI.mot_comp_uv.launches == n0 + 1
    torch.cuda.synchronize()
    for g, wv in zip(got, want):
        assert np.array_equal(g.cpu().numpy(), wv.numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("ratio,pos", [(2, 1), (4, 3), (16, 7)])
def test_cuda_pyramid_matches_plain(ratio, pos):
    dev = _cuda()
    rng = np.random.default_rng(70 + ratio)
    r0, r1 = _mk_refs(rng, 352, 288, (2, 3))
    want = TI.interpolate_frames(r0.to("cpu"), r1.to("cpu"), ratio, pos)
    n0 = (TI.me_level.launches, TI.mot_comp.launches,
          TI.mot_comp_uv.launches)
    got = TI.interpolate_frames(r0.to(dev), r1.to(dev), ratio, pos)
    torch.cuda.synchronize()
    assert (TI.me_level.launches, TI.mot_comp.launches,
            TI.mot_comp_uv.launches) == (n0[0] + 4, n0[1] + 1, n0[2] + 1)
    for g, wv in zip(got, want):
        assert np.array_equal(g.cpu().numpy(), wv.numpy())


@pytest.mark.gpu
def test_cuda_wrappers_raise_on_bad_tensors():
    dev = _cuda()
    p = torch.zeros((80, 80), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="pic1p"):
        TI.me_level(p, p.to(torch.int32), None, None, (1, 1), w=16, h=16,
                    pad=32, guided=False)
    m = torch.zeros((2, 2, 2), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="plane 1"):
        TI.mot_comp(p, p[:, :40], m, m, w=16, h=16, cs=8, clip_pad=4,
                    base=32)
