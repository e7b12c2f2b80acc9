"""Intra scan: the port's plain version (thor_tpu_torch.ops.intra) against
thor_tpu.ops.jax_kernels.intra_scan and, on a tiny case, the Pallas kernel
in interpret mode; the CUDA kernel against the plain version on the card.

Random quadtree intra TU tilings in decode order (the generator style of
tests/test_pallas_intra.py), random modes, availability flags and
residuals. The dependency rule the CUDA kernel schedules by
(IT.intra_levels) is pinned on the CPU: the plain scan run level by level,
the TUs of a level in a shuffled order, must give the decode-order result.
Tolerance: exact equality.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke as S
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


# ---------------------------------------------------------------------------
# the dependency rule behind the kernel's schedule (CPU)
# ---------------------------------------------------------------------------

TESTDATA = Path(__file__).resolve().parent.parent / "testdata"


def _causal_case(seed, C, H, W, max_s):
    """A random tiling whose availability flags follow decode order, as a
    stream's do: the up-right / down-left samples count as available only
    where earlier TUs cover all of them, and then 1 or `size` of them."""
    rng = np.random.default_rng(seed)
    tiles = _random_tiling(rng, H, W, 4, max_s)
    owner = np.full((H // 4 + 16, W // 4 + 16), -1, np.int64)
    for t, (y, x, s) in enumerate(tiles):
        owner[y // 4:(y + s) // 4, x // 4:(x + s) // 4] = t
    n = len(tiles)
    tus = {k: np.zeros(n, np.int32) for k in IT.FIELDS}
    for t, (y, x, s) in enumerate(tiles):
        upr = owner[(y - 1) // 4, (x + s) // 4:(x + 2 * s) // 4] \
            if y > 0 and x + 2 * s <= W else np.array([-1])
        dnl = owner[(y + s) // 4:(y + 2 * s) // 4, (x - 1) // 4] \
            if x > 0 and y + 2 * s <= H else np.array([-1])
        ext = [int(rng.choice([0, 1, s])) if (o.min() >= 0 and o.max() < t)
               else 0 for o in (upr, dnl)]
        for k, v in zip(IT.FIELDS, (y, x, s, rng.integers(0, 11),
                                    s + ext[0], s + ext[1],
                                    int(x > 0 and rng.integers(0, 2)))):
            tus[k][t] = v
    planes = rng.integers(0, 256, (C, H, W)).astype(np.int32)
    resid = rng.integers(-300, 300, (C, H, W)).astype(np.int32)
    return IT.build_intra_records(tus, H, W), planes, resid


def _stream_records(name, want_inter):
    """(luma records, chroma records, H, W) of the first frame of a
    stream, or of its first P/B frame that holds intra TUs."""
    from thor_tpu_torch.bitstream.reader import BitReader, iter_frames
    from thor_tpu_torch.codec.constants import MAX_REF_FRAMES
    from thor_tpu_torch.dec.inputs import build_frame_inputs
    from thor_tpu_torch.dec.parse import SequenceHeader
    from thor_tpu_torch.native import parse_frame, seqhdr_from_python
    payloads = iter_frames(str(TESTDATA / name))
    first = next(payloads)
    br = BitReader(first)
    seq = SequenceHeader.read(br)
    cs = seqhdr_from_python(seq)
    nums, pos, payload = [0] * MAX_REF_FRAMES, br.pos, first
    while True:
        nf = parse_frame(payload, pos, cs, nums)
        cfg, inp, _ = build_frame_inputs(nf, seq, nums)
        if "it_y" in inp and (cfg.R > 0) == want_inter:
            return inp["it_y"], inp["it_c"], seq.height, seq.width
        nums = [nf.hdr.display_frame_num] + nums[:-1]
        payload, pos = next(payloads), 0


def _scan_by_levels(planes, resid, recs, seed):
    """The plain scan run level by level, each level's TUs shuffled."""
    rng = np.random.default_rng(seed)
    levels = IT.intra_levels(recs)
    P, R = torch.from_numpy(planes), torch.from_numpy(resid)
    for lvl in range(1, int(levels.max()) + 1):
        idx = rng.permutation(np.flatnonzero(levels == lvl))
        P = IT.intra_scan_plain(P, R, torch.from_numpy(recs[idx]))
    return P.numpy(), levels


@pytest.mark.parametrize("C,H,W,max_s,seed", [
    (1, 128, 192, 64, 10), (1, 64, 64, 16, 11), (2, 64, 96, 32, 12),
    (2, 32, 64, 8, 13)])
def test_levels_reproduce_decode_order(C, H, W, max_s, seed):
    recs, planes, resid = _causal_case(seed, C, H, W, max_s)
    want = IT.intra_scan_plain(torch.from_numpy(planes),
                               torch.from_numpy(resid),
                               torch.from_numpy(recs)).numpy()
    got, levels = _scan_by_levels(planes, resid, recs, seed)
    assert np.array_equal(got, want)
    # a real graph: fewer levels than TUs, more than one TU in some level
    assert 1 < levels.max() < len(recs)


@pytest.mark.parametrize("name,want_inter", [
    ("intra_only.bit", False), ("LDB_medium_complexity.bit", True)])
def test_levels_reproduce_decode_order_on_stream_records(name, want_inter):
    """The TU records of a stream's I frame and of a P frame: luma and the
    chroma pair, on seeded planes and residuals."""
    rec_y, rec_c, H, W = _stream_records(name, want_inter)
    rng = np.random.default_rng(len(rec_y))
    for C, recs, h, w in ((1, rec_y, H, W), (2, rec_c, H // 2, W // 2)):
        planes = rng.integers(0, 256, (C, h, w)).astype(np.int32)
        resid = rng.integers(-300, 300, (C, h, w)).astype(np.int32)
        want = IT.intra_scan_plain(torch.from_numpy(planes),
                                   torch.from_numpy(resid),
                                   torch.from_numpy(recs)).numpy()
        got, levels = _scan_by_levels(planes, resid, recs, C)
        assert np.array_equal(got, want)
        assert levels.max() < len(recs)


def test_levels_of_simple_layouts():
    """A row of TUs is one chain; TUs that touch nothing are one level; a
    TU right of an earlier one, below nothing, waits for it alone."""
    def recs(tiles):
        return np.array([(y, x, s, 0, s, s, int(x > 0)) for y, x, s in tiles],
                        np.int32)
    assert IT.intra_levels(recs([(0, 8 * i, 8) for i in range(9)])).tolist() \
        == list(range(1, 10))
    assert IT.intra_levels(recs([(64 * i, 64 * j, 16) for i in range(3)
                                 for j in range(3)])).tolist() == [1] * 9
    assert IT.intra_levels(recs([(0, 0, 8), (16, 0, 8), (16, 8, 8),
                                 (8, 8, 4)])).tolist() == [1, 1, 2, 2]
    assert len(IT.intra_levels(np.zeros((0, 7), np.int32))) == 0


def test_records_reject_unaligned_tu():
    tus, _, _ = _gen(0, 1, 64, 64, 32)
    tus["tx"] = tus["tx"] + 2
    with pytest.raises(ValueError, match="4x4"):
        IT.build_intra_records(tus, 64, 128)


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


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(5))
def test_cuda_intra_edge_shapes(case):
    """The shapes the multi-block scan can get wrong (4x4 TUs only, a pure
    chain, scattered TUs, flags that do not follow decode order): equal to
    the plain version 20 times in a row, and once more while a spinning
    kernel on a second stream holds most SMs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    label, planes, resid, recs = S.intra_edge_cases(torch.device("cuda"))[case]
    want = IT.intra_scan_plain(planes.cpu(), resid.cpu(), recs.cpu())
    S.repeat_check(f"intra_scan[{label}]",
                   lambda: (IT.intra_scan(planes, resid, recs),),
                   (want.to(planes.device),), 2)


@pytest.mark.gpu
def test_cuda_intra_no_tu_launches_nothing():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    planes, resid, recs = S.random_intra_case(3, 1, 64, 64, 16,
                                              torch.device("cuda"))
    n0 = IT.intra_scan.launches
    got = IT.intra_scan(planes, resid, recs[:0])
    assert torch.equal(got, planes) and IT.intra_scan.launches == n0
