"""Block MC: the port's plain version (thor_tpu_torch.ops.mc) against the
gather MC thor_tpu.ops.jax_kernels.mc_frame and, on a tiny case, the
Pallas kernel in interpret mode; the CUDA kernel against the plain
version on the card.

Random quadtree-like PU tilings with random MVs, slots and bipred flags,
in the style of tests/test_pallas_mc.py. The rule the CUDA kernel's
separable path relies on (every phase an outer product of its row and
column sums over 64, but the luma (1/2, 1/2) one) is pinned on the CPU.
Tolerance: exact equality.
"""

import numpy as np
import pytest
import torch

from thor_tpu_torch.ops import mc as M
from thor_tpu_torch.ops.kernels import build_chroma_mc_lut, build_luma_mc_lut

try:
    import jax.numpy as jnp
    from thor_tpu.ops import jax_kernels as JK
    from thor_tpu.ops import pallas_mc as PM
except ImportError:     # a card's machine without JAX runs the gpu tests
    jnp = JK = PM = None  # only: pytest --noconftest -m gpu

# plane -> (pad, frac_bits, tap_lo, cell size, min PU, max PU, T)
PLANES = {"luma": (96, 2, -2, 4, 4, 64, 6),
          "chroma": (48, 3, -1, 2, 2, 32, 4)}


def _random_tiling(rng, H, W, min_s, max_s):
    """Random aligned power-of-2 tiling of the frame."""
    pus = []

    def split(y, x, s):
        if s > min_s and (s > max_s or y + s > H or x + s > W
                          or rng.random() < 0.5):
            h = s // 2
            for dy in (0, h):
                for dx in (0, h):
                    if y + dy < H and x + dx < W:
                        split(y + dy, x + dx, h)
        else:
            pus.append((y, x, min(s, H - y), min(s, W - x)))

    for y in range(0, H, max_s):
        for x in range(0, W, max_s):
            split(y, x, max_s)
    return pus


def _gen(rng, H, W, R, plane, has_bi):
    pad, fb, _, _, min_s, max_s, _ = PLANES[plane]
    tiles = _random_tiling(rng, H, W, min_s, max_s)
    n = len(tiles)
    lim = (pad - 8) << fb
    pus = {k: np.array([t[i] for t in tiles]) for i, k in
           enumerate(("y0", "x0", "h", "w"))}
    for k in ("slot0", "slot1"):
        pus[k] = rng.integers(0, R, n)
    for k in ("mvx0", "mvy0", "mvx1", "mvy1"):
        pus[k] = rng.integers(-lim, lim + 1, n)
    pus["bi"] = rng.integers(0, 2, n) if has_bi else np.zeros(n, int)
    return pus


def _cells_from_pus(pus, H, W, cs):
    cell = {k: np.zeros((H // cs, W // cs), np.int32) for k in
            ("mv0x", "mv0y", "mv1x", "mv1y", "slot0", "slot1", "bi")}
    src = {"mv0x": "mvx0", "mv0y": "mvy0", "mv1x": "mvx1", "mv1y": "mvy1",
           "slot0": "slot0", "slot1": "slot1", "bi": "bi"}
    for i in range(len(pus["y0"])):
        r = np.s_[pus["y0"][i] // cs:(pus["y0"][i] + pus["h"][i]) // cs,
                  pus["x0"][i] // cs:(pus["x0"][i] + pus["w"][i]) // cs]
        for k, s in src.items():
            cell[k][r] = pus[s][i]
    return cell


def _lut(plane):
    lut = build_luma_mc_lut(1) if plane == "luma" else build_chroma_mc_lut()
    return lut, torch.from_numpy(lut.reshape(lut.shape[0], -1))


def _case(seed, plane, has_bi, H, W, R=2):
    rng = np.random.default_rng(seed)
    pad = PLANES[plane][0]
    C = 1 if plane == "luma" else 2
    refs = rng.integers(0, 256, (C, R, H + 2 * pad, W + 2 * pad),
                        dtype=np.uint8)
    return refs, _gen(rng, H, W, R, plane, has_bi)


def _port(refs, pus, plane, H, W):
    pad, fb, tap_lo, _, _, _, T = PLANES[plane]
    recs, clamped = M.build_mc_records(pus, H, W, pad, fb, tap_lo, T)
    assert clamped == 0
    _, lut_t = _lut(plane)
    return M.mc_frame(torch.from_numpy(refs), torch.from_numpy(recs),
                      lut_t, H, W).numpy()


@pytest.mark.parametrize("plane", ["luma", "chroma"])
@pytest.mark.parametrize("has_bi", [False, True])
def test_plain_mc_matches_gather(plane, has_bi):
    H, W = (128, 192) if plane == "luma" else (64, 96)
    refs, pus = _case(10 + has_bi, plane, has_bi, H, W)
    pad, fb, tap_lo, cs, _, _, _ = PLANES[plane]
    lut, _ = _lut(plane)
    got = _port(refs, pus, plane, H, W)
    cell = _cells_from_pus(pus, H, W, cs)
    for c in range(refs.shape[0]):
        want = np.asarray(JK.mc_frame(
            jnp.asarray(refs[c]), *(jnp.asarray(cell[k]) for k in (
                "mv0x", "mv0y", "mv1x", "mv1y", "slot0", "slot1", "bi")),
            lut, pad, fb, cs, H, W, tap_lo, has_bi=has_bi))
        assert np.array_equal(got[c], want), \
            f"mismatch at {np.argwhere(got[c] != want)[:5]}"


def test_plain_mc_matches_pallas_interpret():
    """A tiny luma case through the TPU kernel in interpret mode."""
    H, W = 32, 64
    refs, pus = _case(3, "luma", True, H, W)
    lut, _ = _lut("luma")
    recs, cnt = PM.build_mc_records(pus, H, W, pad=96, frac_bits=2,
                                    tap_lo=-2, TH=64, TW=128)
    want = np.asarray(PM.mc_frame_pallas(
        jnp.asarray(refs[0]), jnp.asarray(recs), jnp.asarray(cnt), lut, H,
        W, 64, 128, interpret=True))
    assert np.array_equal(_port(refs, pus, "luma", H, W)[0], want)


def test_records_split_large_pus():
    """64x64 luma PUs become 16 pieces of 16x16 with shifted windows."""
    pus = {"y0": np.array([0]), "x0": np.array([64]), "h": np.array([64]),
           "w": np.array([64]), "slot0": np.array([1]),
           "mvx0": np.array([-5]), "mvy0": np.array([7]),
           "bi": np.array([1]), "slot1": np.array([0]),
           "mvx1": np.array([3]), "mvy1": np.array([-2])}
    recs, _ = M.build_mc_records(pus, 128, 192, 96, 2, -2, 6)
    assert recs.shape == (16, M.NF)
    assert (recs[:, M.R_H] == 16).all() and (recs[:, M.R_W] == 16).all()
    # floor semantics: -5 >> 2 == -2, phase (7&3)*4 + (-5&3) = 15
    assert recs[0, M.R_IX0] == 64 + (-2) + 96 - 2
    assert recs[0, M.R_P0] == 15
    assert set(recs[:, M.R_IY0] - recs[:, M.R_Y0]) == {(7 >> 2) + 96 - 2}


def test_window_origin_clamped():
    """A window leaving the padded plane splits into 4x4 cells, each
    moved into the plane as dynamic_slice moves a start index (-106 and
    -102 count from the far edge of the 256-wide plane) and counted; list 1
    of a uni PU mirrors list 0 and is not counted."""
    pus = {"y0": np.array([0]), "x0": np.array([0]), "h": np.array([8]),
           "w": np.array([8]), "slot0": np.array([0]),
           "mvx0": np.array([-4 * 200]), "mvy0": np.array([0]),
           "bi": np.array([0]), "slot1": np.array([1]),
           "mvx1": np.array([4 * 500]), "mvy1": np.array([0])}
    recs, clamped = M.build_mc_records(pus, 64, 64, 96, 2, -2, 6)
    assert clamped == 4 and recs.shape == (4, M.NF)
    assert sorted(recs[:, M.R_IX0]) == [150, 150, 154, 154]
    assert (recs[:, M.R_H] == 4).all() and (recs[:, M.R_W] == 4).all()
    assert sorted(recs[:, M.R_IY0]) == [94, 94, 98, 98]
    for a, b in ((M.R_S0, M.R_S1), (M.R_P0, M.R_P1), (M.R_IY0, M.R_IY1),
                 (M.R_IX0, M.R_IX1)):
        assert (recs[:, a] == recs[:, b]).all()


@pytest.mark.parametrize("plane", ["luma", "chroma"])
@pytest.mark.parametrize("has_bi", [False, True])
def test_plain_mc_clamps_like_dynamic_slice(plane, has_bi):
    """MVs reaching past the pad: each cell's window is clamped as the
    per-cell gather thor_tpu.ops.jax_kernels.mc_plane clamps it."""
    H, W = (64, 96) if plane == "luma" else (32, 48)
    pad, fb, tap_lo, cs, min_s, max_s, T = PLANES[plane]
    rng = np.random.default_rng(40 + has_bi)
    C = 1 if plane == "luma" else 2
    refs = rng.integers(0, 256, (C, 2, H + 2 * pad, W + 2 * pad),
                        dtype=np.uint8)
    pus = _gen(rng, H, W, 2, plane, has_bi)
    lim = (pad + 3 * max_s) << fb
    for k in ("mvx0", "mvy0", "mvx1", "mvy1"):
        pus[k] = rng.integers(-lim, lim + 1, len(pus["y0"]))
    recs, clamped = M.build_mc_records(pus, H, W, pad, fb, tap_lo, T)
    assert clamped > 0
    lut, lut_t = _lut(plane)
    got = M.mc_frame(torch.from_numpy(refs), torch.from_numpy(recs),
                     lut_t, H, W).numpy()
    cell = _cells_from_pus(pus, H, W, cs)
    for c in range(C):
        ref = jnp.asarray(refs[c])

        def pred(mx, my, sl):
            return np.asarray(JK.mc_plane(
                ref, jnp.asarray(cell[mx]), jnp.asarray(cell[my]),
                jnp.asarray(cell[sl]), lut, pad, fb, cs, H, W, tap_lo))

        want = pred("mv0x", "mv0y", "slot0")
        if has_bi:
            bi = np.kron(cell["bi"], np.ones((cs, cs), np.int32)) != 0
            want = np.where(bi, (want + pred("mv1x", "mv1y", "slot1")) >> 1,
                            want)
        assert np.array_equal(got[c], want), \
            f"mismatch at {np.argwhere(got[c] != want)[:5]}"


@pytest.mark.gpu
@pytest.mark.parametrize("plane", ["luma", "chroma"])
@pytest.mark.parametrize("past_pad", [False, True])
def test_cuda_mc_matches_plain(plane, past_pad):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    H, W = (128, 192) if plane == "luma" else (64, 96)
    refs, pus = _case(21, plane, True, H, W, R=3)
    pad, fb, tap_lo, _, _, max_s, T = PLANES[plane]
    if past_pad:          # windows clamped cell by cell
        lim = (pad + 3 * max_s) << fb
        for k in ("mvx0", "mvy0", "mvx1", "mvy1"):
            pus[k] = np.random.default_rng(22).integers(
                -lim, lim + 1, len(pus["y0"]))
    recs, _ = M.build_mc_records(pus, H, W, pad, fb, tap_lo, T)
    _, lut = _lut(plane)
    want = M.mc_frame_plain(torch.from_numpy(refs), torch.from_numpy(recs),
                            lut, H, W)
    dev = torch.device("cuda")
    n0 = M.mc_frame.launches
    got = M.mc_frame(torch.from_numpy(refs).to(dev),
                     torch.from_numpy(recs).to(dev), lut.to(dev), H, W)
    torch.cuda.synchronize()
    assert M.mc_frame.launches == n0 + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("table", ["luma_uni", "luma_bi", "chroma"])
def test_lut_phases_factor_by_their_sums(table):
    """Every phase's T x T weights are fv (x) fh with fv, fh its row and
    column sums over 64, except luma phase 10, the (1/2, 1/2) low-pass; and
    a horizontal pass then a vertical one gives the integers of the T x T
    sum on random windows."""
    lut = {"luma_uni": build_luma_mc_lut(0), "luma_bi": build_luma_mc_lut(1),
           "chroma": build_chroma_mc_lut()}[table].astype(np.int64)
    rng = np.random.default_rng(len(table))
    T = lut.shape[1]
    win = rng.integers(0, 256, (50, T, T)).astype(np.int64)
    for p, L in enumerate(lut):
        rs, cs = L.sum(1), L.sum(0)
        sep = (rs % 64 == 0).all() and (cs % 64 == 0).all() \
            and np.array_equal(np.outer(rs // 64, cs // 64), L)
        assert sep == (not (table != "chroma" and p == 10)), p
        if sep:
            two_d = (L[None] * win).sum(axis=(1, 2))
            hv = ((win * (cs // 64)[None, None, :]).sum(2)
                  * (rs // 64)[None, :]).sum(1)
            assert np.array_equal((two_d + 2048) >> 12, (hv + 2048) >> 12)


def _every_phase_pus(seed, plane, H, W, R, has_bi):
    """A random tiling whose list-0 and list-1 MVs walk through every
    fractional phase of the plane (16 luma, 64 chroma) in turn."""
    rng = np.random.default_rng(seed)
    pad, fb, _, _, _, _, _ = PLANES[plane]
    pus = _gen(rng, H, W, R, plane, has_bi)
    n = len(pus["y0"])
    ph = np.arange(n) % (1 << 2 * fb)
    lim = (pad - 8) // 2
    for k, sh in (("mvx0", 0), ("mvy0", fb), ("mvx1", fb), ("mvy1", 0)):
        frac = (np.roll(ph, 3 * (k[-1] == "1")) >> sh) & ((1 << fb) - 1)
        pus[k] = (rng.integers(-lim, lim + 1, n) << fb) + frac
    return pus


def _cuda_equals_plain(refs, recs, plane, H, W):
    _, lut = _lut(plane)
    want = M.mc_frame_plain(torch.from_numpy(refs), torch.from_numpy(recs),
                            lut, H, W)
    dev = torch.device("cuda")
    n0 = M.mc_frame.launches
    got = M.mc_frame(torch.from_numpy(refs).to(dev),
                     torch.from_numpy(recs).to(dev), lut.to(dev), H, W)
    torch.cuda.synchronize()
    assert M.mc_frame.launches == n0 + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("plane", ["luma", "chroma"])
@pytest.mark.parametrize("has_bi", [False, True])
def test_cuda_mc_every_phase(plane, has_bi):
    """Every phase, the (1/2, 1/2) luma one, which takes the kernel's 2-D
    path, included; uni and bi PUs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    H, W = (128, 192) if plane == "luma" else (96, 128)
    pad, fb, tap_lo, _, _, _, T = PLANES[plane]
    pus = _every_phase_pus(30 + has_bi, plane, H, W, 2, has_bi)
    recs, clamped = M.build_mc_records(pus, H, W, pad, fb, tap_lo, T)
    assert clamped == 0
    phases = set(recs[:, M.R_P0].tolist()) | set(recs[:, M.R_P1].tolist())
    assert phases == set(range(1 << 2 * fb))
    refs = np.random.default_rng(31).integers(
        0, 256, (1 if plane == "luma" else 2, 2, H + 2 * pad, W + 2 * pad),
        dtype=np.uint8)
    _cuda_equals_plain(refs, recs, plane, H, W)


@pytest.mark.gpu
@pytest.mark.parametrize("plane", ["luma", "chroma"])
@pytest.mark.parametrize("past_pad", [False, True])
def test_cuda_mc_one_reference_odd_widths(plane, past_pad):
    """R = 1, and planes whose width is a multiple of no tile (198 luma,
    99 chroma: pieces 2 and 3 wide at the right edge, padded rows that
    start at every byte offset of a word), with and without clamped
    cells."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    H, W = (136, 198) if plane == "luma" else (68, 99)
    refs, pus = _case(40 + past_pad, plane, True, H, W, R=1)
    pad, fb, tap_lo, _, _, max_s, T = PLANES[plane]
    if past_pad:
        lim = (pad + 3 * max_s) << fb
        for k in ("mvx0", "mvy0", "mvx1", "mvy1"):
            pus[k] = np.random.default_rng(41).integers(
                -lim, lim + 1, len(pus["y0"]))
    recs, clamped = M.build_mc_records(pus, H, W, pad, fb, tap_lo, T)
    assert (clamped > 0) == past_pad
    assert (refs.shape[3] % 4) != 0
    _cuda_equals_plain(refs, recs, plane, H, W)
