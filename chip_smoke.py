#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (thor_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits nonzero):
  1. device: the card's name and power limit;
  2. build: every CUDA kernel from thor_tpu_torch/csrc (and the C parser
     and the encoder's C walk), with nvcc's register / shared-memory
     report;
  3. kernels: each kernel against its plain PyTorch version on the card;
     exact equality; times from CUDA events. Block MC and the intra scan at
     the shapes of the 1080p LDB stream (first P frame, I frame) and on
     seeded random tilings. The interpolation kernels (pyramid ME, luma and
     chroma synthesis, the latter two writing the padded reference planes,
     U/V on vectors it derives from the luma field) at every level of the
     1080p RA16 stream's first interpolated frame and on seeded correlated
     frames at (ratio, pos) (2,1), (4,3), (16,7); the synthesis also on
     seeded 1080p vectors past the halo; the kernels one interpolate_frames
     call launches, and those from level 0's maps to the padded planes,
     counted by torch.profiler. The encoder's intra scan on seeded tilings
     (luma and U+V, fast and exact transforms, intra and inter quantizer
     offsets) and at the TU records of the 1080p encode's first frame,
     with the records' dependency chain, its widest level and the us per
     level; the cost of one link by TU size (a pure chain of each size
     across the 1080p width); the share of the MC call that its output
     memset takes. The three multi-SM kernels (intra scan, encoder scan,
     pyramid ME) also at the shapes their scheduling can get wrong (more
     block rows or units than the card holds, one row, one column, a pure
     chain of TUs, scattered TUs, 4x4 or 64x64 TUs only, all-zero levels,
     no TU), each 20 times in a row with equal results and once while a
     spinning kernel on a second stream holds most SMs;
  4. slices, each with every launch counter set to 0 just before and read
     just after: the 1080p LDB stream (sha256) and the LDB / intra CIF
     goldens; then the 1080p RA16 stream (sha256), the RA / RA16 / HDB CIF
     goldens and RA16_long (sha256), which must launch all five decoder
     kernels and call no plain version; fps of both 1080p decodes, three
     repeats. Then the Python parse route: both 1080p streams decoded with
     collect_stats=True (the instrumented Python parser on the parse
     thread, dec/syntax_inputs.py into the frame program), each equal to
     its sha256 golden, its Thordec statistics report equal to thor_tpu's
     committed testdata/torch_dec_stats_<stream>.txt, with the counters
     around it (mc_frame and intra_scan on both, kernels 3-5 on RA16, no
     plain call), its seconds and the serial Python parse's ms per frame;
     RA16 again with digest=True, each frame's device checksum equal to
     frame_digest_np of the golden-checked frame; the numpy backend (host
     only) on the CIF goldens, RA16_long and the 1080p LDB stream, with
     its seconds per frame. Then the device encoder: an all-intra encode
     of three 1920x1080 frames (the top-left crop of
     testdata/test_4k.yuv), which the port's decoder must read back to the
     encoder's reconstruction; a CIF encode with the fast transforms
     through the command line; and
     the three committed thor_tpu all-intra streams
     (testdata/torch_enc_intra_*.bit), which the card must reproduce byte
     for byte. Then the encoder's P and B frames: frames 0-3 of the same
     1080p crop in the LDB form of LDB_medium_complexity_1080.bit's header
     (I P P P, two references, bipred), each frame with the counters set
     to 0 just before and read just after (mc_frame on every P frame,
     encode_scan on every P frame with intra leaves, no plain call), its
     stage times, peak memory and PSNR-Y, then the same encode with every
     frame under torch.profiler (kernel launches, device busy and idle
     share), the P-frame fps, and the decode of the stream back to the
     reconstruction; the thor_tpu P/B streams ldb_qcif and ra_qcif byte for
     byte, the RA one through kernels 3-5 on its interpolated references.
     Then the host mirror encoder (device_encode=0: the block search in
     numpy on the host, the filters and references on the card): the four
     thor_tpu mirror streams (testdata/torch_enc_host_*.bit: all-intra
     CIF, LDB QCIF and CIF, RA QCIF) byte for byte, each with the counters
     set to 0 just before and read just after (kernels 3-5 on the RA one,
     no other kernel, no plain call) and decoded back to the encoder's
     reconstruction through kernels 1-5 (counted the same way); the
     search and filter seconds of every frame and the CIF fps; one CIF P
     frame under torch.profiler (device busy and idle share); a mirror
     encode (host_ldb_qcif) and a device encode (ldb_qcif) split at a
     checkpoint after frame 1 and resumed, equal to their goldens. Then
     the parallel paths (thor_tpu_torch/parallel), slots as streams of the
     one card: ShardedDecoder on the 1080p RA16 stream at meshes 1x1, 2x1,
     4x1, 2x2 and 1x4, each equal to its sha256 with thor_tpu's dependency
     levels (testdata/torch_levels.json) and the counters around it
     (kernels 1-5, no plain call), with fps beside the Decoder's in the
     same rounds; the 1080p LDB stream at 1x2 and 1x4; the 4x1 decode and
     a Decoder decode under torch.profiler (device busy and idle share,
     the ms in which kernels of two or more streams overlap, launches);
     RA16_long through `python -m thor_tpu_torch.dec --mesh 4x2` (sha256,
     a level of 8); kernels 1 and 3 each on two streams at once, 20 times,
     against their plain versions; two gloo processes of
     parallel/worker.py on the card (DIST_OK); ShardedEncoder on two
     streams: ldb_qcif and ra_qcif byte for byte, and a 5-frame 1080p RA
     form (I P B B B) equal to the sequential Encoder's bytes in the same
     call, with both encodes' seconds and stage times, decoded back to
     its reconstruction;
  5. a {"kernels": [...]} JSON line (six kernels; mc_frame and encode_scan
     with their launches in the P/B encode; each with its launches over
     the mirror encodes, over the two collect_stats decodes, over the 4x1
     sharded RA16 decode and over the sharded 1080p RA-form encode);
  6. last line: {"ok": true, "device": {...}}.
Imports nothing of JAX or thor_tpu. Without a CUDA device it exits 1 and
prints no result.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
TESTDATA = HERE / "testdata"
STREAM_1080 = TESTDATA / "LDB_medium_complexity_1080.bit"
STREAM_RA_1080 = TESTDATA / "RA16_high_efficiency_1080.bit"
CIF_STREAMS = ("intra_only", "LDB_low_complexity", "LDB_medium_complexity",
               "LDB_high_efficiency")
CIF_INTERP_STREAMS = ("RA_low_complexity", "RA16_high_efficiency",
                      "HDB16_medium_complexity")
FPS_REPEATS = 3

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
INT_OPS_PER_S = 67e12         # float32 outside the tensor cores: the
#                               guide's table has no int32 rate


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def time_ms(fn, warmup=3, iters=20):
    """Mean device ms per call of `fn`, from CUDA events. `iters` calls
    are captured into one CUDA graph (their kernel launches and
    allocations, not the wrapper's host work) and the graph is replayed
    between two events, so that a kernel shorter than its wrapper's host
    time is still timed on the card and not on the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def covered_ref_bytes(recs, R, Hp, Wp, T, C):
    """Distinct reference bytes the records' tap windows touch (a 2-D
    difference array over [R, Hp+1, Wp+1], summed per list)."""
    from thor_tpu_torch.ops import mc as M
    diff = torch.zeros((R, Hp + 1, Wp + 1), dtype=torch.int32,
                       device=recs.device)
    r = recs.long()
    hh, ww = r[:, M.R_H] + T - 1, r[:, M.R_W] + T - 1
    one = torch.ones(len(r), dtype=torch.int32, device=recs.device)
    for s_, iy, ix, use in ((M.R_S0, M.R_IY0, M.R_IX0, None),
                            (M.R_S1, M.R_IY1, M.R_IX1, r[:, M.R_BI] != 0)):
        sel = slice(None) if use is None else use
        s, y, x = r[sel, s_], r[sel, iy], r[sel, ix]
        h, w, o = hh[sel], ww[sel], one[sel]
        for dy, dx, sign in ((0, 0, 1), (0, 1, -1), (1, 0, -1), (1, 1, 1)):
            diff.index_put_((s, y + dy * h, x + dx * w), sign * o,
                            accumulate=True)
    cover = diff.cumsum(1).cumsum(2)
    return int((cover > 0).sum()) * C


def mc_bound(recs, R, Hp, Wp, T, C, H, W):
    """Least time for one mc_frame call: bytes (reference windows,
    records, LUT, int32 output) over HBM rate vs tap MACs over the
    integer rate."""
    from thor_tpu_torch.ops import mc as M
    r = recs.long()
    pix = (r[:, M.R_H] * r[:, M.R_W]).sum().item()
    pix_bi = (r[:, M.R_H] * r[:, M.R_W] * (r[:, M.R_BI] != 0)).sum().item()
    nbytes = (covered_ref_bytes(recs, R, Hp, Wp, T, C)
              + recs.numel() * 4 + C * H * W * 4)
    ops = 2 * T * T * C * (pix + pix_bi)
    return nbytes, ops


def intra_bound(recs, C):
    """Bytes one intra_scan call must move: per TU its residual read and
    its pixels written (int32), its 2s+1 context samples read, and its
    record. What holds the kernel back is the longest dependency chain
    among the TUs (ops/intra.intra_levels), not these bytes."""
    s = recs[:, 2].long()
    per_plane = (8 * s * s + 4 * (2 * s + 1)).sum().item()
    return C * per_plane + recs.numel() * 4


def bound_ms(nbytes, ops):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / INT_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ---------------------------------------------------------------------------
# seeded random tilings
# ---------------------------------------------------------------------------

def random_tiling(rng, H, W, min_s, max_s, clip):
    """Aligned power-of-2 quadtree tiling in decode order; with clip,
    pieces crossing the frame edge are split or cut to it."""
    out = []

    def split(y, x, s):
        cross = y + s > H or x + s > W
        if s > min_s and (rng.random() < 0.5 or (clip and cross)):
            h = s // 2
            for dy in (0, h):
                for dx in (0, h):
                    if y + dy < H and x + dx < W:
                        split(y + dy, x + dx, h)
        else:
            out.append((y, x, min(s, H - y), min(s, W - x)))

    for y in range(0, H, max_s):
        for x in range(0, W, max_s):
            split(y, x, max_s)
    return out


def random_mc_case(seed, H, W, C, pad, fb, tap_lo, T, min_s, max_s, dev):
    from thor_tpu_torch.ops import mc as M
    rng = np.random.default_rng(seed)
    R = 2
    tiles = random_tiling(rng, H, W, min_s, max_s, clip=True)
    n = len(tiles)
    lim = (pad - 8) << fb
    pus = {k: np.array([t[i] for t in tiles]) for i, k in
           enumerate(("y0", "x0", "h", "w"))}
    for k in ("slot0", "slot1"):
        pus[k] = rng.integers(0, R, n)
    for k in ("mvx0", "mvy0", "mvx1", "mvy1"):
        pus[k] = rng.integers(-lim, lim + 1, n)
    pus["bi"] = rng.integers(0, 2, n)
    recs, clamped = M.build_mc_records(pus, H, W, pad, fb, tap_lo, T)
    assert clamped == 0
    refs = torch.from_numpy(rng.integers(
        0, 256, (C, R, H + 2 * pad, W + 2 * pad), dtype=np.uint8)).to(dev)
    return refs, torch.from_numpy(recs).to(dev)


def random_intra_case(seed, C, H, W, max_s, dev):
    from thor_tpu_torch.ops import intra as IT
    rng = np.random.default_rng(seed)
    tiles = random_tiling(rng, H, W, 4, max_s, clip=False)
    n = len(tiles)
    ty, tx, s = (np.array([t[i] for t in tiles]) for i in range(3))
    tus = {"ty": ty, "tx": tx, "size": s,
           "mode": rng.integers(0, 10, n),
           "toplen": s + ((tx + s < W) & (rng.random(n) < 0.5)),
           "leftlen": s + ((ty + s < H) & (rng.random(n) < 0.5)),
           "cbx_nonzero": (tx > 0) & (rng.random(n) < 0.5)}
    recs = torch.from_numpy(IT.build_intra_records(tus, H, W)).to(dev)
    planes = torch.from_numpy(rng.integers(0, 256, (C, H, W)).astype(
        np.int32)).to(dev)
    resid = torch.from_numpy(rng.integers(-300, 300, (C, H, W)).astype(
        np.int32)).to(dev)
    return planes, resid, recs


def intra_edge_cases(dev):
    """[(label, planes, resid, recs)]: the shapes the multi-block intra
    scan can get wrong. 4x4 TUs only, on the U/V pair, in raster order
    with the up-right sample available; a pure chain (one row of 16x16
    TUs, each reading its predecessor's last column); scattered TUs that
    touch nothing, in a shuffled order; and two random tilings whose
    availability flags do not follow decode order, so that TUs read
    samples a later TU overwrites."""
    from thor_tpu_torch.ops import intra as IT
    rng = np.random.default_rng(90)
    out = []

    def case(label, C, H, W, tiles, toplen, leftlen):
        ty, tx, s = (np.array([t[i] for t in tiles]) for i in range(3))
        tus = {"ty": ty, "tx": tx, "size": s,
               "mode": rng.integers(0, 10, len(tiles)),
               "toplen": np.asarray(toplen), "leftlen": np.asarray(leftlen),
               "cbx_nonzero": tx > 0}
        recs = torch.from_numpy(IT.build_intra_records(tus, H, W)).to(dev)
        planes, resid = (torch.from_numpy(rng.integers(
            lo, hi, (C, H, W)).astype(np.int32)).to(dev)
            for lo, hi in ((0, 256), (-300, 300)))
        out.append((label, planes, resid, recs))

    H, W = 64, 96
    tiles = [(y, x, 4) for y in range(0, H, 4) for x in range(0, W, 4)]
    case("4x4 TUs only, U+V", 2, H, W, tiles,
         [4 + (y > 0 and x + 4 < W) for y, x, _ in tiles], [4] * len(tiles))
    tiles = [(0, x, 16) for x in range(0, 1536, 16)]
    case("pure chain", 1, 16, 1536, tiles, [16] * 96, [16] * 96)
    tiles = [(64 * i, 64 * j, int(rng.choice([4, 8, 16, 32])))
             for i in range(8) for j in range(8)]
    tiles = [tiles[i] for i in rng.permutation(64)]
    case("scattered TUs", 1, 512, 512, tiles,
         [t[2] + 1 for t in tiles], [t[2] + 1 for t in tiles])
    for label, args in (("random Y", (3, 1, 512, 512, 64)),
                        ("random UV", (4, 2, 256, 256, 32))):
        out.append((label, *random_intra_case(*args, dev)))
    return out


def me_case(seed, w, h, pad, guided, gmax, dev):
    """Two correlated padded planes and a guide field on `dev`, so that
    both the skip and the search path of the pyramid ME run."""
    from thor_tpu_torch.ops import interp as TI
    rng = np.random.default_rng(seed)
    bw, bh = TI.me_grid(w, h)
    p0, p1 = (rng.integers(0, 256, (h + 2 * pad, w + 2 * pad), np.uint8)
              for _ in range(2))
    p1[pad:pad + h, pad:pad + w] = np.clip(
        p0[pad - 1:pad - 1 + h, pad + 1:pad + 1 + w].astype(np.int32)
        + rng.integers(-3, 4, (h, w)), 0, 255).astype(np.uint8)
    g = (rng.integers(-gmax, gmax + 1, (2, bh, bw)) * 8).astype(np.int32)
    return tuple(torch.from_numpy(a).to(dev) for a in (p0, p1, g[0], g[1]))


# (label, w, h, pad, guided, (wt0, wt1)): the shapes the row wavefront of
# the pyramid ME can get wrong. (3, 1) are the weights of (ratio, pos) =
# (4, 3), which takes the reversed path; (9, 7) those of (16, 7).
ME_EDGE_CASES = (
    ("272 block rows (more than SMs)", 256, 4352, 32, True, (1, 1)),
    ("unguided, 12 block rows", 64, 192, 32, False, (9, 7)),
    ("one block row", 512, 16, 32, True, (3, 1)),
    ("one block column", 16, 512, 32, False, (1, 1)),
    ("one block", 16, 16, 32, True, (3, 1)),
    ("CIF, unequal weights", 352, 288, 96, True, (9, 7)),
)


def occupy_sms(blocks_per_sm, spare_sms, ms, stream):
    """Launch the spinning test aid (csrc/occupy.cu) on `stream`: it holds
    all but `spare_sms` SMs with `blocks_per_sm` blocks of 1024 threads
    each for `ms` milliseconds."""
    import ctypes
    from thor_tpu_torch.ops import _build
    L = _build.cuda_library("occupy")
    L.thor_occupy.restype = ctypes.c_int
    L.thor_occupy.argtypes = [ctypes.c_int] * 3 + [ctypes.c_ulonglong,
                                                    ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    err = L.thor_occupy(blocks_per_sm * (sms - spare_sms), 1024,
                        (220 * 1024) // blocks_per_sm - 1024,
                        int(ms * 1e6), stream.cuda_stream)
    if err:
        raise RuntimeError(f"the occupy aid did not launch (CUDA error {err})")


def repeat_check(what, kern, want, blocks_per_sm, repeats=20):
    """`kern()` (a tuple of tensors) equals `want` `repeats` times in a
    row, and once more while the occupy aid holds most SMs on a second
    stream."""
    for i in range(repeats + 1):
        if i == repeats:
            side = torch.cuda.Stream()
            occupy_sms(blocks_per_sm, 8, 30.0, side)
        got = kern()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(
                f"{what}: run {i} differs from the plain version"
                + (" (card partly occupied)" if i == repeats else ""))
    torch.cuda.synchronize()
    ms = time_ms(kern, warmup=1, iters=5)
    log(f"[kernel] {what}: equal to plain {repeats} times in a row and once "
        f"with most SMs held by another stream; kernel_ms={ms:.4f}")


def phase_edge_shapes(dev):
    """The three multi-SM kernels at the shapes of intra_edge_cases,
    enc_edge_cases and ME_EDGE_CASES, against their plain versions."""
    from thor_tpu_torch.ops import interp as TI
    from thor_tpu_torch.ops import intra as IT
    for label, planes, resid, recs in intra_edge_cases(dev):
        want = IT.intra_scan_plain(planes, resid, recs)
        lv = IT.intra_levels(recs.cpu().numpy())
        repeat_check(f"intra_scan[{label}, {len(recs)} TUs on "
                     f"{planes.shape[0]} planes, chain {lv.max()}]",
                     lambda: (IT.intra_scan(planes, resid, recs),), (want,), 2)
    planes, resid, recs = random_intra_case(3, 1, 64, 64, 16, dev)
    n0 = IT.intra_scan.launches
    got = IT.intra_scan(planes, resid, recs[:0])
    if not torch.equal(got, planes) or IT.intra_scan.launches != n0:
        raise AssertionError("intra_scan with no TU must return the planes "
                             "and launch nothing")
    log("[kernel] intra_scan[no TU]: the planes come back, nothing launched")
    from thor_tpu_torch.ops import enc_intra as EI
    for label, planes, org, recs, qp, fast, intra in enc_edge_cases(dev):
        want = EI.encode_scan_plain(planes, org, recs, qp, fast, intra)
        chain, widest = chain_stats(recs)
        repeat_check(f"encode_scan[{label}, {len(recs)} TUs on "
                     f"{planes.shape[0]} planes, chain {chain}, widest level "
                     f"{widest}, {int((want[1] != 0).sum())} nonzero levels]",
                     lambda: EI.encode_scan(planes, org, recs, qp, fast,
                                            intra),
                     want, 1)
    n0 = EI.encode_scan.launches
    got, q16 = EI.encode_scan(planes, org, recs[:0], 30, False, True)
    if not torch.equal(got, planes) or q16.shape[0] or \
            EI.encode_scan.launches != n0:
        raise AssertionError("encode_scan with no TU must return the planes "
                             "and launch nothing")
    log("[kernel] encode_scan[no TU]: the planes come back, nothing launched")
    for i, (label, w, h, pad, guided, wts) in enumerate(ME_EDGE_CASES):
        p0, p1, gx, gy = me_case(100 + i, w, h, pad, guided, 6, dev)
        kw = dict(w=w, h=h, pad=pad, guided=guided)
        t0 = time.perf_counter()
        want = TI.me_level_plain(p0, p1, gx, gy, wts, **kw)
        torch.cuda.synchronize()
        bw, bh = TI.me_grid(w, h)
        repeat_check(f"me_level[{label}: {w}x{h}, {bw // 2}x{bh // 2} blocks, "
                     f"weights {wts}, plain_ms="
                     f"{(time.perf_counter() - t0) * 1e3:.0f}]",
                     lambda: TI.me_level(p0, p1, gx, gy, wts, **kw), want, 1)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    log(line)
    name = torch.cuda.get_device_name(0)
    log(f"[device] torch.cuda.get_device_name(0) = {name}; "
        f"count = {torch.cuda.device_count()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    return line, name


def phase_build():
    from thor_tpu_torch import native
    from thor_tpu_torch.ops import _build
    t0 = time.perf_counter()
    for name in _build.CUDA_SOURCES:
        _build.cuda_library(name)
    native.lib()
    native.decide_lib()
    native.interp_lib()
    dt = time.perf_counter() - t0
    log(f"[build] CUDA kernels {list(_build.CUDA_SOURCES)}, the C parser, "
        f"the encoder's C walk and emit and the host interpolation ready in "
        f"{dt:.2f} s (the CUDA sources built in parallel; into "
        f"{_build.BUILD_DIR})")
    for name in _build.CUDA_SOURCES:
        for ln in _build.BUILD_LOG.get(name, "").splitlines():
            if any(w in ln for w in ("registers", "Compiling entry", "spill",
                                     "error", "warning")):
                log(f"[build] {name}: {ln.strip()}")


def first_frames(dev):
    """Inputs of the 1080p stream's I frame (0) and first P frame (1),
    and the reference window after frame 0, all on `dev`."""
    from thor_tpu_torch.bitstream.reader import BitReader, iter_frames
    from thor_tpu_torch.codec.constants import MAX_REF_FRAMES
    from thor_tpu_torch.dec.decoder import Decoder, RefFrame
    from thor_tpu_torch.dec.inputs import build_frame_inputs
    from thor_tpu_torch.dec.parse import SequenceHeader
    from thor_tpu_torch.dec.reconstruct import (mc_luts, reconstruct_frame,
                                                to_device)
    from thor_tpu_torch.native import parse_frame, seqhdr_from_python

    payloads = iter_frames(str(STREAM_1080))
    p0, p1 = next(payloads), next(payloads)
    br = BitReader(p0)
    seq = SequenceHeader.read(br)
    dec = Decoder(device=dev)
    dec.start(seq)
    cs = seqhdr_from_python(seq)
    luts = mc_luts(seq.bipred, dev)
    nums = [0] * MAX_REF_FRAMES
    nf0 = parse_frame(p0, br.pos, cs, nums)
    cfg0, inp0, _ = build_frame_inputs(nf0, seq, nums)
    inp0 = to_device(inp0, dev)
    _, padded = reconstruct_frame(cfg0, inp0, [], luts)
    window = [RefFrame(*padded, nf0.hdr.display_frame_num)] + dec.refs[:-1]
    nums = [nf0.hdr.display_frame_num] + nums[:-1]
    nf1 = parse_frame(p1, 0, cs, nums)
    cfg1, inp1, slots1 = build_frame_inputs(nf1, seq, nums)
    assert cfg0.R == 0 and cfg1.R > 0 and inp1["mc_clamped"] == 0
    return seq, luts, (cfg0, inp0), (cfg1, to_device(inp1, dev),
                                     [window[s] for s in slots1])


def phase_kernels(dev):
    """Kernels against plain versions; returns per-kernel rows."""
    from thor_tpu_torch.dec.reconstruct import residual_planes
    from thor_tpu_torch.ops import intra as IT
    from thor_tpu_torch.ops import mc as M

    seq, luts, (cfg0, inp0), (cfg1, inp1, refs1) = first_frames(dev)
    H, W = seq.height, seq.width
    rows = {"mc_frame": [], "intra_scan": []}
    max_err = {"mc_frame": 0, "intra_scan": 0}

    def check(kname, label, kern, plain, bound, timed=True):
        got = kern()
        t0 = time.perf_counter()
        want = plain()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = int((got.long() - want.long()).abs().max().item())
        max_err[kname] = max(max_err[kname], err)
        if err:
            raise AssertionError(f"{kname}[{label}]: kernel differs from "
                                 f"its plain version (max |err| {err})")
        b_ms, b_by = bound_ms(*bound)
        if not timed:
            log(f"[kernel] {kname}[{label}] equal to plain "
                f"({len(got.shape)}-d output {tuple(got.shape)})")
            return
        ms = time_ms(kern)
        log(f"[kernel] {kname}[{label}] equal to plain; kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.2f} bound_ms={b_ms:.5f} ({b_by})")
        rows[kname].append((ms, plain_ms, b_ms, b_by, bound))

    # block MC at the first P frame (Y: one launch, U+V: one launch)
    refY = torch.stack([r.y for r in refs1])[None]
    refUV = torch.stack([torch.stack([r.u for r in refs1]),
                         torch.stack([r.v for r in refs1])])
    R = len(refs1)
    for label, refs, recs, lut, h, w, T, C in (
            ("Y", refY, inp1["mc_y"], luts[0], H, W, 6, 1),
            ("UV", refUV, inp1["mc_c"], luts[1], H // 2, W // 2, 4, 2)):
        check("mc_frame", f"1080p P frame {label}, {len(recs)} records",
              lambda: M.mc_frame(refs, recs, lut, h, w),
              lambda: M.mc_frame_plain(refs, recs, lut, h, w),
              mc_bound(recs, R, refs.shape[2], refs.shape[3], T, C, h, w))
        zeros_ms = time_ms(lambda: torch.zeros((C, h, w), dtype=torch.int32,
                                               device=dev))
        log(f"[kernel] mc_frame[1080p P frame {label}]: the wrapper's "
            f"torch.zeros of the int32 output takes {zeros_ms:.4f} ms, "
            f"{zeros_ms / rows['mc_frame'][-1][0] * 100:.1f} % of the call")
    # seeded random PU tilings at 1080p, uni + bi
    for label, args, lut in (
            ("random Y", (1, H, W, 1, 96, 2, -2, 6, 4, 64), luts[0]),
            ("random UV", (2, H // 2, W // 2, 2, 48, 3, -1, 4, 2, 32),
             luts[1])):
        refs, recs = random_mc_case(*args, dev)
        h, w = args[1], args[2]
        T, C = args[7], args[3]
        check("mc_frame", label, lambda: M.mc_frame(refs, recs, lut, h, w),
              lambda: M.mc_frame_plain(refs, recs, lut, h, w),
              mc_bound(recs, 2, refs.shape[2], refs.shape[3], T, C, h, w),
              timed=False)

    # intra scan at the I frame (Y: one launch, U+V: one launch)
    ry, rc = residual_planes(cfg0, inp0, dev)
    y0 = torch.zeros((1, H, W), dtype=torch.int32, device=dev)
    uv0 = torch.zeros((2, H // 2, W // 2), dtype=torch.int32, device=dev)
    chains = []
    for label, planes, resid, recs, C in (
            ("Y", y0, ry[None].contiguous(), inp0["it_y"], 1),
            ("UV", uv0, rc, inp0["it_c"], 2)):
        chains.append(int(IT.intra_levels(recs.cpu().numpy()).max()))
        check("intra_scan", f"1080p I frame {label}, {len(recs)} TUs, "
              f"chain {chains[-1]}",
              lambda: IT.intra_scan(planes, resid, recs),
              lambda: IT.intra_scan_plain(planes, resid, recs),
              (intra_bound(recs, C), 0))
    # the first P frame's intra TUs: scattered, on the frame's own residual
    # (timed, but not part of the per-frame row)
    assert "it_y" in inp1
    ry1, rc1 = residual_planes(cfg1, inp1, dev)
    for label, planes, resid, recs, C in (
            ("Y", y0, ry1[None].contiguous(), inp1["it_y"], 1),
            ("UV", uv0, rc1, inp1["it_c"], 2)):
        lv = int(IT.intra_levels(recs.cpu().numpy()).max())
        want = IT.intra_scan_plain(planes, resid, recs)
        if not torch.equal(IT.intra_scan(planes, resid, recs), want):
            raise AssertionError(f"intra_scan[1080p P frame {label}] differs "
                                 "from its plain version")
        ms = time_ms(lambda: IT.intra_scan(planes, resid, recs))
        log(f"[kernel] intra_scan[1080p P frame {label}, {len(recs)} TUs, "
            f"chain {lv}] equal to plain; kernel_ms={ms:.4f}")
    for label, args in (("random Y", (3, 1, 512, 512, 64)),
                        ("random UV", (4, 2, 256, 256, 32))):
        planes, resid, recs = random_intra_case(*args, dev)
        check("intra_scan", label,
              lambda: IT.intra_scan(planes, resid, recs),
              lambda: IT.intra_scan_plain(planes, resid, recs),
              (intra_bound(recs, args[1]), 0), timed=False)
    log(f"[kernel] intra scan at the 1080p I frame: {len(inp0['it_y'])} luma "
        f"TUs in a dependency chain of {chains[0]}, {len(inp0['it_c'])} "
        f"chroma TUs in one of {chains[1]} (ops/intra.intra_levels)")
    return rows, max_err


class _Frame:
    """Codec-padded planes of one frame."""

    def __init__(self, y, u, v):
        self.y, self.u, self.v = y, u, v


def correlated_frames(seed, w, h, shift, dev):
    """Two seeded correlated codec-padded frames on `dev`: the second is
    the first moved by `shift` pels, plus noise."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + 64, w + 64), np.uint8)
    y0 = base[32:32 + h, 32:32 + w]
    y1 = base[32 + shift[0]:32 + shift[0] + h,
              32 + shift[1]:32 + shift[1] + w]
    y1 = np.clip(y1.astype(np.int32) + rng.integers(-4, 5, y1.shape),
                 0, 255).astype(np.uint8)

    def mk(y):
        u = y[::2, ::2].copy()
        return _Frame(*(torch.from_numpy(np.pad(p, n, mode="edge")).to(dev)
                        for p, n in ((y, 96), (u, 48), (255 - u, 48))))
    return mk(y0), mk(y1)


def first_interp_pair(dev):
    """(r1, r2, ratio, pos) of the 1080p RA16 stream's first interpolated
    frame: decodes the stream on the card until that frame is reached."""
    from thor_tpu_torch.dec.decoder import Decoder

    class Probe(Decoder):
        pair = None

        def _make_interp_frame(self, fh):
            if Probe.pair is None:
                Probe.pair = self.interp_pair(fh)
            super()._make_interp_frame(fh)

    for _ in Probe(device=dev).decode_stream(str(STREAM_RA_1080)):
        if Probe.pair is not None:
            break
    return Probe.pair


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def check_pyramid(label, r0, r1, ratio, pos, rows, max_err, timed):
    """One whole synthesis on the card through the kernels; every kernel
    call's inputs then go through its plain version and the outputs must
    be equal. With `timed`, each kernel is also timed at these inputs and
    its bound computed, and a row is kept."""
    from thor_tpu_torch.ops import interp as TI

    def same(kname, what, got, want, plain_ms):
        err = max(int((g.long() - v.long()).abs().max().item())
                  for g, v in zip(got, want))
        max_err[kname] = max(max_err[kname], err)
        if err:
            raise AssertionError(f"{kname}[{label} {what}]: kernel differs "
                                 f"from its plain version (max |err| {err})")
        if not timed:
            log(f"[kernel] {kname}[{label} {what}] equal to plain "
                f"(plain_ms={plain_ms:.1f})")

    def plain_run(fn, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def keep(kname, what, kern, plain_ms, bound, note="", iters=20):
        b_ms, b_by = bound_ms(*bound)
        ms = time_ms(kern, warmup=2, iters=iters)
        log(f"[kernel] {kname}[{label} {what}] equal to plain; "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.2f} "
            f"bound_ms={b_ms:.5f} ({b_by}){note}")
        rows[kname].append((ms, plain_ms, b_ms, b_by, bound))

    calls = []
    r0, r1, maps, wts, w, h = TI.level0_motion(
        r0, r1, ratio, pos, on_level=lambda *c: calls.append(c))
    dev = r0.y.device
    for lvl, a, kw, maps_l in calls:
        want, plain_ms = plain_run(TI.me_level_plain, *a, **kw)
        bw, bh = TI.me_grid(kw["w"], kw["h"])
        what = (f"level {lvl} {kw['w']}x{kw['h']} "
                f"{'guided' if kw['guided'] else 'unguided'}, "
                f"{bw // 2}x{bh // 2} blocks")
        same("me_level", what, maps_l, want, plain_ms)
        if timed:
            stats = torch.zeros(2, dtype=torch.int64, device=dev)
            TI.me_level(*a, stats=stats, **kw)
            e16, e8 = stats.tolist()
            bound = (nbytes(a[0], a[1]) + (7 if kw["guided"] else 5)
                     * bw * bh * 4, 3 * (256 * e16 + 64 * e8))
            keep("me_level", what, lambda: TI.me_level(*a, **kw), plain_ms,
                 bound, note=f"; {bw * bh // 4} blocks in a chain of "
                 f"{bw // 2 + bh - 2} steps, {e16} 16x16 and {e8} 8x8 SADs "
                 f"needed", iters=5)

    # the two synthesis kernels, each writing its padded reference planes
    m0, m1 = TI.cell_vectors(maps)
    ykw = dict(w=w, h=h, base=TI.PAD_Y, pad=TI.PAD_Y)
    yp = TI.mot_comp(r0.y, r1.y, m0, m1, **ykw)
    want, plain_ms = plain_run(TI.mot_comp_plain, r0.y, r1.y, m0, m1, **ykw)
    what = f"{w}x{h} padded to {yp.shape[1]}x{yp.shape[0]}"
    same("mot_comp", what, (yp,), (want,), plain_ms)
    if timed:
        keep("mot_comp", what,
             lambda: TI.mot_comp(r0.y, r1.y, m0, m1, **ykw), plain_ms,
             (synthesis_bytes("mot_comp", w, h, 2, 2, yp), 3 * yp.numel()))
    ckw = dict(w=w // 2, h=h // 2, base=TI.PAD_C, pad=TI.PAD_C)
    ca = (r0.u, r1.u, r0.v, r1.v, m1, wts)
    uv = TI.mot_comp_uv(*ca, **ckw)
    want, plain_ms = plain_run(TI.mot_comp_uv_plain, *ca, **ckw)
    what = (f"2 x {w // 2}x{h // 2} padded to {uv[0].shape[1]}x"
            f"{uv[0].shape[0]}, weights {wts}")
    same("mot_comp_uv", what, uv, want, plain_ms)
    if timed:
        keep("mot_comp_uv", what, lambda: TI.mot_comp_uv(*ca, **ckw),
             plain_ms, (synthesis_bytes("mot_comp_uv", w // 2, h // 2, 4, 1,
                                        *uv), 3 * 2 * uv[0].numel()))


def synthesis_bytes(kname, w, h, planes, fields, *outs):
    """Bytes a synthesis call must move: of each input plane only the
    windows' reach, the plane and its +-clip_pad halo; of each vector field
    the cells that cover the plane; each padded output once."""
    from thor_tpu_torch.ops import interp as TI
    cs, clip = TI.MC_GEOMETRY[kname]
    cells = -(-w // cs) * -(-h // cs)
    return (planes * (w + 2 * clip) * (h + 2 * clip) + fields * cells * 8
            + nbytes(*outs))


def window_paths(mv0, mv1, w, h, cs, clip):
    """(cells with both windows inside the halo, with one, with none) of
    a synthesis call's grid: the average of unclipped windows, one window
    alone, and the average of windows clipped pixel by pixel."""
    def inside(mv):
        bh, bw = mv.shape[:2]
        xs = (torch.arange(bw, device=mv.device) * cs)[None] \
            + ((mv[..., 0] + 4) >> 3)
        ys = (torch.arange(bh, device=mv.device) * cs)[:, None] \
            + ((mv[..., 1] + 4) >> 3)
        return ((xs >= -clip) & (xs + cs <= w + clip) & (ys >= -clip)
                & (ys + cs <= h + clip))
    i0, i1 = inside(mv0), inside(mv1)
    return (int((i0 & i1).sum()), int((i0 ^ i1).sum()),
            int((~i0 & ~i1).sum()))


def check_synthesis_past_halo(seed, max_err, dev):
    """Both synthesis kernels at 1080p on seeded planes and cell vectors
    built like the CPU tests' _mc_case: luma vectors up to 64 pels, past
    the 4-pel (chroma 2-pel) halo, a third of each field cut to stay
    inside, on a grid one cell row past the plane. So the one-window and
    the clipped path run on the card at the main path's shapes."""
    from thor_tpu_torch.ops import interp as TI
    rng = np.random.default_rng(seed)
    w, h = 1920, 1080
    bw, bh = TI.me_grid(w, h)
    bh += 1
    mv = rng.integers(-64 * 8, 64 * 8 + 1, (2, bh, bw, 2)).astype(np.int32)
    mv[0, ::3, ::2] //= 16
    mv[1, ::2, ::3] //= 16
    m0, m1 = (torch.from_numpy(a).to(dev) for a in mv)
    ys = [torch.from_numpy(rng.integers(
        0, 256, (h + 2 * TI.PAD_Y, w + 2 * TI.PAD_Y), np.uint8)).to(dev)
        for _ in range(2)]
    cs = [torch.from_numpy(rng.integers(
        0, 256, (h // 2 + 2 * TI.PAD_C, w // 2 + 2 * TI.PAD_C),
        np.uint8)).to(dev) for _ in range(4)]
    wts = (9, 7)
    ykw = dict(w=w, h=h, base=TI.PAD_Y, pad=TI.PAD_Y)
    ckw = dict(w=w // 2, h=h // 2, base=TI.PAD_C, pad=TI.PAD_C)
    for kname, kern, plain, paths in (
            ("mot_comp", lambda: (TI.mot_comp(*ys, m0, m1, **ykw),),
             lambda: (TI.mot_comp_plain(*ys, m0, m1, **ykw),),
             window_paths(m0, m1, w, h, *TI.MC_GEOMETRY["mot_comp"])),
            ("mot_comp_uv", lambda: TI.mot_comp_uv(*cs, m1, wts, **ckw),
             lambda: TI.mot_comp_uv_plain(*cs, m1, wts, **ckw),
             window_paths(*TI.chroma_vectors(m1, wts), w // 2, h // 2,
                          *TI.MC_GEOMETRY["mot_comp_uv"]))):
        got, want = kern(), plain()
        err = max(int((g.long() - v.long()).abs().max().item())
                  for g, v in zip(got, want))
        max_err[kname] = max(max_err[kname], err)
        if err:
            raise AssertionError(f"{kname}[seeded 1080p past the halo]: "
                                 f"kernel differs from its plain version "
                                 f"(max |err| {err})")
        log(f"[kernel] {kname}[seeded 1080p, vectors past the halo, {bw}x"
            f"{bh} cells: {paths[0]} both windows inside, {paths[1]} one, "
            f"{paths[2]} none (clipped)] equal to plain; "
            f"kernel_ms={time_ms(kern):.4f}")


def count_launches(r1, r2, ratio, pos):
    """Kernels that one interpolate_frames call on (r1, r2) launches, and
    those of its part from level 0's maps to the three padded planes
    (ops/interp.synthesize), counted by torch.profiler on warm calls."""
    from thor_tpu_torch.ops import interp as TI
    from thor_tpu_torch.utils.profile_decode import profile_run
    level0 = TI.level0_motion(r1, r2, ratio, pos)
    TI.interpolate_frames(r1, r2, ratio, pos)
    TI.synthesize(*level0)
    torch.cuda.synchronize()
    n_all = profile_run(lambda: TI.interpolate_frames(r1, r2, ratio, pos))[4]
    _, _, _, top, n_tail = profile_run(lambda: TI.synthesize(*level0))
    log(f"[launches] interpolate_frames on the 1080p RA16 frame: {n_all} "
        f"kernels; from level 0's maps to the three padded planes "
        f"(ops/interp.synthesize): {n_tail}: "
        + "; ".join(f"{n} x {name} {ms:.4f} ms" for ms, n, name in top)
        + " (torch.profiler)")
    if n_tail > 6:
        raise AssertionError(f"the synthesis from level 0's maps launched "
                             f"{n_tail} kernels, more than 6")


def phase_interp_kernels(dev):
    """The three interpolation kernels against their plain versions.
    Every shape is compared, the finest 1080p level included (the plain
    ME decides a whole wavefront of blocks at a time, so it is affordable
    there); rows are timed at the 1080p stream's frame only."""
    names = ("me_level", "mot_comp", "mot_comp_uv")
    rows = {k: [] for k in names}
    max_err = {k: 0 for k in names}
    r1, r2, ratio, pos = first_interp_pair(dev)
    check_pyramid(f"1080p RA16 first interpolated frame ({ratio},{pos})",
                  r1, r2, ratio, pos, rows, max_err, timed=True)
    count_launches(r1, r2, ratio, pos)
    for seed, (w, h), (ratio, pos) in ((5, (352, 288), (2, 1)),
                                       (6, (352, 288), (4, 3)),
                                       (7, (352, 288), (16, 7)),
                                       (8, (1920, 1080), (4, 3))):
        a, b = correlated_frames(seed, w, h, (2, 3), dev)
        check_pyramid(f"seeded {w}x{h} ({ratio},{pos})", a, b, ratio, pos,
                      rows, max_err, timed=False)
    check_synthesis_past_halo(9, max_err, dev)
    return rows, max_err


def decode(path, dev):
    """(frames, sha256 of the output, output bytes or None for a 1080p
    stream) of one decode; fails if an MC window left the padded plane."""
    from thor_tpu_torch.dec.decoder import Decoder
    dec = Decoder(device=dev)
    h = hashlib.sha256()
    keep = [] if path not in (STREAM_1080, STREAM_RA_1080) else None
    n = 0
    for planes in dec.decode_stream(str(path)):
        for p in planes:
            h.update(p.tobytes())
            if keep is not None:
                keep.append(p.tobytes())
        n += 1
    if dec.mc_clamped:
        raise AssertionError(f"{path.name}: {dec.mc_clamped} MC windows "
                             "leave the padded reference plane")
    return n, h.hexdigest(), keep and b"".join(keep)


def all_counters():
    from thor_tpu_torch.ops import enc_intra as EI
    from thor_tpu_torch.ops import interp as TI
    from thor_tpu_torch.ops import intra as IT
    from thor_tpu_torch.ops import mc as M
    return ((M.mc_frame, IT.intra_scan, TI.me_level, TI.mot_comp,
             TI.mot_comp_uv, EI.encode_scan),
            (M.mc_frame_plain, IT.intra_scan_plain, TI.me_level_plain,
             TI.mot_comp_plain, TI.mot_comp_uv_plain, EI.encode_scan_plain))


def zero_counters():
    counters, plains = all_counters()
    for f in counters:
        f.launches = 0
    for f in plains:
        f.calls = 0


def read_counters():
    counters, plains = all_counters()
    return ({f.__name__: f.launches for f in counters},
            {f.__name__: f.calls for f in plains})


def counted_decode(path, dev, must_launch):
    """Decode with every counter set to 0 just before and read just
    after; every kernel in `must_launch` must have launched and no plain
    version been called."""
    zero_counters()
    n, sha, _ = decode(path, dev)
    launches, plain_calls = read_counters()
    per_frame = {k: round(v / n, 3) for k, v in launches.items()}
    log(f"[slice] {path.name}: launches {launches} ({per_frame} per "
        f"frame); plain calls {plain_calls}")
    if not all(launches[k] for k in must_launch) or any(plain_calls.values()):
        raise AssertionError(f"{path.name}: the decode did not run through "
                             f"the kernels {must_launch} alone")
    return n, sha, launches


def check_goldens(names, dev):
    for name in names:
        golden = TESTDATA / f"{name}_dec.yuv"
        nf, sha, got = decode(TESTDATA / f"{name}.bit", dev)
        if golden.exists():
            ok, what = got == golden.read_bytes(), golden.name
        else:
            want = (TESTDATA / f"{name}_dec.sha256").read_text().split()[0]
            ok, what = sha == want, f"{name}_dec.sha256"
        log(f"[slice] {name}: {nf} frames "
            f"{'match' if ok else 'DIFFER FROM'} {what}")
        if not ok:
            raise AssertionError(f"{name} does not match its golden")


def timed_decodes(path, want, dev, card):
    """FPS_REPEATS warm decodes in a row, each on the host clock and
    ending in torch.cuda.synchronize(), sha256 checked every time."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fps = []
    for _ in range(FPS_REPEATS):
        t0 = time.perf_counter()
        n, sha, _ = decode(path, dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if sha != want:
            raise AssertionError(f"timed decode of {path.name} does not "
                                 "match its golden")
        fps.append(n / dt)
    med = sorted(fps)[len(fps) // 2]
    log(f"[slice] {path.name} decode fps={med:.3f} (median of "
        f"{FPS_REPEATS} warm decodes of {n} frames: "
        f"{', '.join(f'{x:.3f}' for x in fps)}; spread "
        f"{(max(fps) - min(fps)) / med * 100:.1f} % of the median; host "
        f"clock, each ends in torch.cuda.synchronize()); "
        f"max_memory_allocated={torch.cuda.max_memory_allocated()} B; "
        f"card {card}")


def phase_slice(path, must_launch, goldens, dev, card):
    """One main path: the 1080p stream (sha256, 17 frames) with the
    counters read around it, the CIF-size goldens that take the same
    path, then the timed decodes."""
    want = path.with_name(path.stem + "_dec.sha256").read_text().split()[0]
    n, sha, launches = counted_decode(path, dev, must_launch)
    log(f"[slice] {path.name}: {n} frames sha256 {sha} "
        f"{'matches' if sha == want else 'DIFFERS FROM'} golden; no MC "
        f"window left the padded plane")
    if sha != want or n != 17:
        raise AssertionError(f"{path.name} does not match its golden")
    check_goldens(goldens, dev)
    timed_decodes(path, want, dev, card)
    return launches, n



# ---------------------------------------------------------------------------
# the Python parse route with Thordec's statistics, the digest, the numpy
# backend
# ---------------------------------------------------------------------------

def python_parse_seconds(path):
    """Seconds of the Python parse of every frame of `path`, serially on
    the host: FrameParser alone, and with the adapter to the C parse's
    layout (dec/syntax_inputs.py) that the card route feeds its input
    builder."""
    from thor_tpu_torch.bitstream.reader import BitReader, iter_frames
    from thor_tpu_torch.codec.constants import MAX_REF_FRAMES
    from thor_tpu_torch.dec.parse import FrameParser, SequenceHeader
    from thor_tpu_torch.dec.syntax_inputs import syntax_to_native

    payloads = list(iter_frames(str(path)))
    br = BitReader(payloads[0])
    seq = SequenceHeader.read(br)
    nums, pos, t_parse, t_adapt = [0] * MAX_REF_FRAMES, br.pos, 0.0, 0.0
    for p in payloads:
        b = BitReader(p)
        b.pos = pos
        t0 = time.perf_counter()
        fs = FrameParser(seq, b, nums).parse()
        t1 = time.perf_counter()
        syntax_to_native(fs, seq)
        t_adapt += time.perf_counter() - t1
        t_parse += t1 - t0
        nums, pos = [fs.display_frame_num] + nums[:-1], 0
    return len(payloads), t_parse, t_adapt


def stats_decode(path, must_launch, dev, card):
    """Decoder(collect_stats=True) on the card: the Python parse on the
    parse thread, through the adapter into the frame program. The frames
    must equal the sha256 golden, the report the committed thor_tpu
    report, and every kernel in `must_launch` must launch with no plain
    version called (counters set to 0 just before, read just after).
    Returns the launches and frame_digest_np of every frame."""
    from thor_tpu_torch.dec.__main__ import report
    from thor_tpu_torch.dec.decoder import Decoder, frame_digest_np
    from tools.gen_torch_dec_stats import report_path

    n, t_parse, t_adapt = python_parse_seconds(path)
    want = path.with_name(path.stem + "_dec.sha256").read_text().split()[0]
    zero_counters()
    t0 = time.perf_counter()
    dec = Decoder(device=dev, collect_stats=True)
    h, digests = hashlib.sha256(), []
    for planes in dec.decode_stream(str(path)):
        for p in planes:
            h.update(p.tobytes())
        digests.append(frame_digest_np(*planes))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = read_counters()
    same = report(dec.stats) == report_path(path.stem).read_text()
    log(f"[stats] {path.name} with collect_stats on {dev} (Python parse, "
        f"adapter, frame program): {len(digests)} frames sha256 "
        f"{'matches' if h.hexdigest() == want else 'DIFFERS FROM'} golden; "
        f"report {'equals' if same else 'DIFFERS FROM'} "
        f"{report_path(path.stem).name}; decode {wall:.3f} s, "
        f"{len(digests) / wall:.4f} fps (host clock, ends in "
        f"torch.cuda.synchronize(), frame_digest_np of each frame "
        f"included); Python parse alone {t_parse:.3f} s = "
        f"{t_parse / n * 1e3:.1f} ms/frame, adapter {t_adapt / n * 1e3:.2f} "
        f"ms/frame (serial on the host, {n} frames); launches {launches}; "
        f"plain calls {plain}; card {card}")
    if h.hexdigest() != want or len(digests) != 17 or not same:
        raise AssertionError(f"{path.name}: the stats decode differs from "
                             "its golden or its report from thor_tpu's")
    if not all(launches[k] for k in must_launch) or any(plain.values()):
        raise AssertionError(f"{path.name}: the stats decode did not run "
                             f"through the kernels {must_launch} alone")
    return launches, digests


def numpy_decodes(card):
    """The numpy backend (host only) on the CIF goldens, RA16_long and the
    1080p LDB stream; the seconds of each decode."""
    from thor_tpu_torch.dec.decoder import Decoder
    for name in CIF_STREAMS + CIF_INTERP_STREAMS + (
            "RA16_long", STREAM_1080.stem):
        path = TESTDATA / f"{name}.bit"
        t0 = time.perf_counter()
        frames = list(Decoder(backend="numpy").decode_stream(str(path)))
        dt = time.perf_counter() - t0
        got = b"".join(p.tobytes() for f in frames for p in f)
        yuv = TESTDATA / f"{name}_dec.yuv"
        if yuv.exists():
            ok, what = got == yuv.read_bytes(), yuv.name
        else:
            want = (TESTDATA / f"{name}_dec.sha256").read_text().split()[0]
            ok = hashlib.sha256(got).hexdigest() == want
            what = f"{name}_dec.sha256"
        log(f"[numpy] {name}: {len(frames)} frames "
            f"{'match' if ok else 'DIFFER FROM'} {what}; {dt:.3f} s, "
            f"{dt / len(frames):.4f} s/frame (host numpy and C, native "
            f"parse; host of card {card})")
        if not ok:
            raise AssertionError(f"numpy backend: {name} differs from its "
                                 "golden")


def phase_python_route(dev, card):
    """The Python parse route with Thordec's statistics on both 1080p
    streams, the digest decode of RA16, the numpy backend. Returns the
    launches of the two stats decodes."""
    from thor_tpu_torch.dec.decoder import Decoder
    t_phase = time.perf_counter()
    ldb = ("mc_frame", "intra_scan")
    launches_ldb, _ = stats_decode(STREAM_1080, ldb, dev, card)
    launches_ra, digests = stats_decode(STREAM_RA_1080, ldb + SYNTH, dev,
                                        card)
    t0 = time.perf_counter()
    got = list(Decoder(device=dev).decode_stream(str(STREAM_RA_1080),
                                                 digest=True))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    same = [int(x) for x in got] == [int(x) for x in digests]
    log(f"[stats] {STREAM_RA_1080.name} digest=True (native parse): "
        f"{len(got)} uint32 checksums "
        f"{'equal' if same else 'DIFFER FROM'} frame_digest_np of the "
        f"golden-checked frames; {dt:.3f} s, {len(got) / dt:.3f} fps; "
        f"first {[int(x) for x in got[:3]]}; card {card}")
    if not same:
        raise AssertionError("digest decode differs from frame_digest_np")
    numpy_decodes(card)
    log(f"[stats] Python-route phase: {time.perf_counter() - t_phase:.1f} s "
        f"in all (host clock); card {card}")
    return launches_ldb, launches_ra


# ---------------------------------------------------------------------------
# the device encoder: kernel 6 and the all-intra slice
# ---------------------------------------------------------------------------

ENC_1080 = dict(width=1920, height=1080, qp=32, intra_period=1, num_frames=3,
                device_encode=1, intra_rdo=1, deblocking=1, clpf=1,
                use_block_contexts=1)
ENC_CIF_FAST = ["-width", "352", "-height", "288", "-n", "2", "-qp", "32",
                "-intra_period", "1", "-device_encode", "1", "-intra_rdo",
                "0", "-encoder_speed", "2", "-max_delta_qp", "1"]


def enc_params(fields):
    """EncoderParams built in code, float fields through float32 as the
    reference stores them."""
    from thor_tpu_torch.enc.encoder import FLOAT_PARAMS, EncoderParams
    p = EncoderParams(**fields)
    for f in FLOAT_PARAMS:
        setattr(p, f, float(np.float32(getattr(p, f))))
    return p


def frames_1080(n=3):
    """Frames 0..n-1 of testdata/test_4k.yuv (5 frames), top-left
    1920x1080."""
    from tools.gen_torch_enc_goldens import crop_frames
    return crop_frames(TESTDATA / "test_4k.yuv", 3840, 2160, 1920, 1080, n)


def random_enc_case(seed, C, H, W, min_s, max_s, dev):
    """Seeded mixed tiling with random modes and availability, random
    0..255 start planes and originals (which reach both the int16 wrap of
    the forward stages and the saturation of the inverse ones)."""
    from thor_tpu_torch.ops import intra as IT
    rng = np.random.default_rng(seed)
    tiles = random_tiling(rng, H, W, min_s, max_s, clip=False)
    n = len(tiles)
    ty, tx, s = (np.array([t[i] for t in tiles]) for i in range(3))
    tus = {"ty": ty, "tx": tx, "size": s,
           "mode": rng.integers(0, 10, n),
           "toplen": s + ((tx + s < W) & (rng.random(n) < 0.5)),
           "leftlen": s + ((ty + s < H) & (rng.random(n) < 0.5)),
           "cbx_nonzero": (tx > 0) & (rng.random(n) < 0.5)}
    recs = torch.from_numpy(IT.build_intra_records(tus, H, W)).to(dev)
    planes, org = (torch.from_numpy(rng.integers(0, 256, (C, H, W)).astype(
        np.int32)).to(dev) for _ in range(2))
    return planes, org, recs


def enc_tiles_case(rng, C, H, W, tiles, dev, flat=False):
    """(planes, org, recs) of an encoder scan over `tiles` [(y, x, s)] in
    that order: random modes, the up-right samples where they lie in the
    plane, seeded 0..255 start planes and originals (with `flat`, both
    128 everywhere: every mode then predicts them exactly)."""
    from thor_tpu_torch.ops import intra as IT
    ty, tx, s = (np.array([t[i] for t in tiles]) for i in range(3))
    tus = {"ty": ty, "tx": tx, "size": s,
           "mode": rng.integers(0, 10, len(tiles)),
           "toplen": s + ((ty > 0) & (tx + s < W)), "leftlen": s,
           "cbx_nonzero": tx > 0}
    recs = torch.from_numpy(IT.build_intra_records(tus, H, W)).to(dev)
    planes, org = (torch.full((C, H, W), 128, dtype=torch.int32, device=dev)
                   if flat else torch.from_numpy(rng.integers(
                       0, 256, (C, H, W)).astype(np.int32)).to(dev)
                   for _ in range(2))
    return planes, org, recs


def enc_edge_cases(dev):
    """[(label, planes, org, recs, qp, fast, intra)]: the shapes the
    multi-SM encoder scan can get wrong. 4x4 TUs on the U/V pair, 4 608
    units, more than an H100 holds workers (4 224); a pure chain (a row of
    16x16 TUs, each reading its predecessor's last column); one column of
    TUs; all 64x64 TUs, exact and fast transforms; all-zero levels (a flat
    original and start planes that every mode predicts exactly)."""
    rng = np.random.default_rng(91)
    tiles64 = [(y, x, 64) for y in range(0, 256, 64)
               for x in range(0, 384, 64)]
    cases = (
        ("4x4 TUs only, U+V", 2, 192, 192,
         [(y, x, 4) for y in range(0, 192, 4) for x in range(0, 192, 4)],
         30, False, True),
        ("pure chain", 1, 16, 1536, [(0, x, 16) for x in range(0, 1536, 16)],
         27, False, False),
        ("one column", 1, 1024, 16, [(y, 0, 16) for y in range(0, 1024, 16)],
         33, True, True),
        ("64x64 TUs only, exact", 1, 256, 384, tiles64, 22, False, True),
        ("64x64 TUs only, fast", 1, 256, 384, tiles64, 37, True, False),
        ("all-zero levels, U+V", 2, 128, 128,
         [t[:3] for t in random_tiling(rng, 128, 128, 4, 32, clip=False)],
         30, False, True))
    return [(label, *enc_tiles_case(rng, C, H, W, tiles, dev,
                                    flat=label.startswith("all-zero")),
             qp, fast, intra)
            for label, C, H, W, tiles, qp, fast, intra in cases]


def chain_stats(recs):
    """(longest dependency chain, TUs of the widest level) of a scan's
    records (ops/intra.intra_levels)."""
    from thor_tpu_torch.ops import intra as IT
    lv = IT.intra_levels(recs.cpu().numpy())
    return int(lv.max()), int(np.bincount(lv).max())


def enc_scan_bound(recs, q16, C, H, W, fast):
    """(bytes, integer operations) one encode_scan call must do: the
    original read once and the plane written once (int32), the banks and
    the records; the four matrix stages of every TU and plane, the
    inverse ones only where this run's levels are not all zero."""
    s = recs[:, 2].long()
    qs = torch.clamp(s, max=16)
    n = torch.where(s > 16, torch.full_like(s, 16), s) if fast \
        else torch.clamp(s, max=32)
    m = torch.clamp(s, max=32)
    fwd = 2 * (qs * n * n + qs * qs * n)
    inv = 2 * (m * qs * qs + m * m * qs)
    coded = (q16 != 0).any(dim=3).any(dim=2).long()            # [N, C]
    ops = (fwd * C + inv * coded.sum(dim=1)).sum().item()
    return (2 * C * H * W * 4 + q16.numel() * 2 + recs.numel() * 4, ops)


def enc_frame0(dev):
    """(y, u, v, (luma records, qp), (chroma records, qp)) of the 1080p
    encode's first frame: its original planes (int32 on `dev`) and the
    records of its exact scan, from the port's own search."""
    from thor_tpu_torch.codec.constants import CHROMA_QP
    from thor_tpu_torch.enc import device_intra as DI
    from thor_tpu_torch.enc.encoder import SQUARED_LAMBDA_QP
    p = enc_params(ENC_1080)
    y, u, v = (torch.from_numpy(a).to(dev).to(torch.int32)
               for a in frames_1080()[0])
    qpY, qpC = p.qp, int(CHROMA_QP[p.qp])
    modes, split = DI.search_intra_frame(
        y, u, v, qpY, qpC, p.lambda_coeffI * SQUARED_LAMBDA_QP[qpY],
        p.width, p.height, p.encoder_speed > 1, 10)
    recs_y, recs_c = DI.scan_records(
        DI._walk_tree(split, modes, p.width, p.height), p.width, p.height)
    return y, u, v, (recs_y, qpY), (recs_c, qpC)


def phase_enc_kernel(dev):
    """Kernel 6 against its plain version: planes and coefficient banks
    equal. Returns (rows, max_err) like phase_kernels."""
    from thor_tpu_torch.ops import enc_intra as EI
    rows, max_err = {"encode_scan": []}, {"encode_scan": 0}

    def check(label, planes, org, recs, qp, fast, intra, timed):
        gp, gq = EI.encode_scan(planes, org, recs, qp, fast, intra)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wp, wq = EI.encode_scan_plain(planes, org, recs, qp, fast, intra)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max(int((gp - wp).abs().max().item()),
                  int((gq.int() - wq.int()).abs().max().item()))
        max_err["encode_scan"] = max(max_err["encode_scan"], err)
        if err:
            raise AssertionError(f"encode_scan[{label}]: kernel differs from "
                                 f"its plain version (max |err| {err})")
        coded = int((wq != 0).any(dim=3).any(dim=2).sum().item())
        what = (f"encode_scan[{label}, qp {qp}, "
                f"{'fast' if fast else 'exact'} transforms, "
                f"{'intra' if intra else 'inter'} offsets, {len(recs)} TUs, "
                f"{coded} of {wq.shape[0] * wq.shape[1]} banks coded]")
        if not timed:
            log(f"[kernel] {what} equal to plain (plain_ms={plain_ms:.1f})")
            return
        C, H, W = planes.shape
        bound = enc_scan_bound(recs, gq, C, H, W, fast)
        b_ms, b_by = bound_ms(*bound)
        ms = time_ms(lambda: EI.encode_scan(planes, org, recs, qp, fast,
                                            intra), warmup=2, iters=5)
        log(f"[kernel] {what} equal to plain; kernel_ms={ms:.4f} "
            f"({ms * 1e3 / len(recs):.3f} us per TU) plain_ms={plain_ms:.2f} "
            f"bound_ms={b_ms:.5f} ({b_by})")
        rows["encode_scan"].append((ms, plain_ms, b_ms, b_by, bound))

    seed = 20
    for C, H, W, min_s, max_s in ((1, 256, 192, 8, 64), (2, 128, 96, 4, 32)):
        for fast in (False, True):
            for intra in (True, False):
                seed += 1
                planes, org, recs = random_enc_case(seed, C, H, W, min_s,
                                                    max_s, dev)
                check(f"random {'Y' if C == 1 else 'UV'} {W}x{H}", planes,
                      org, recs, 22 + seed % 17, fast, intra, timed=False)

    # the 1080p encode's first frame: its search, its records
    y, u, v, (recs_y, qpY), (recs_c, qpC) = enc_frame0(dev)
    sizes = np.bincount(recs_y[:, 2], minlength=65)
    by_size = ", ".join(f"{sizes[s]} of {s}x{s}" for s in (8, 16, 32, 64))
    log(f"[kernel] 1080p I frame: {len(recs_y)} TUs per plane class "
        f"({by_size} luma)")
    for label, planes, org, recs, qp in (
            ("Y", torch.zeros_like(y)[None], y[None], recs_y, qpY),
            ("UV", torch.zeros_like(torch.stack([u, v])),
             torch.stack([u, v]), recs_c, qpC)):
        recs = torch.from_numpy(recs).to(dev)
        check(f"1080p I frame {label}", planes, org, recs, qp, False, True,
              timed=True)
        chain, widest = chain_stats(recs)
        log(f"[kernel] encode_scan[1080p I frame {label}]: a dependency "
            f"chain of {chain} levels (ops/intra.intra_levels), the widest "
            f"{widest} TUs; {rows['encode_scan'][-1][0] * 1e3 / chain:.3f} "
            f"us per level")
    # what one link of the chain costs, by TU size: a row of luma TUs
    # across the 1080p width, each reading its predecessor's last column
    rng = np.random.default_rng(92)
    for s in (8, 16, 32, 64):
        n = 1920 // s
        planes, org, recs = enc_tiles_case(
            rng, 1, s, 1920, [(0, x, s) for x in range(0, 1920, s)], dev)
        check(f"pure chain of {n} {s}x{s} TUs", planes, org, recs, 32, False,
              True, timed=False)
        ms = time_ms(lambda: EI.encode_scan(planes, org, recs, 32, False,
                                            True), warmup=2, iters=5)
        log(f"[kernel] encode_scan[pure chain of {n} {s}x{s} TUs]: "
            f"kernel_ms={ms:.4f}, {ms * 1e3 / n:.3f} us per link")
    return rows, max_err


def decode_equals(path, recons, dev, what):
    """The port's decoder reads `path` back to the frames `recons`."""
    from thor_tpu_torch.dec.decoder import Decoder
    dec = list(Decoder(device=dev).decode_stream(str(path)))
    ok = len(dec) == len(recons) and all(
        np.array_equal(a, b) for d, r in zip(dec, recons)
        for a, b in zip(d, r))
    log(f"[slice] {what}: the decoder's {len(dec)} frames "
        f"{'equal' if ok else 'DIFFER FROM'} the encoder's reconstruction")
    if not ok:
        raise AssertionError(f"{what}: decode differs from the encoder's "
                             "reconstruction")


def phase_encode(dev, card, out_dir):
    """The device encoder's I-frame path. Returns the launches of the
    1080p encode."""
    from thor_tpu_torch.enc.__main__ import main as enc_main
    from thor_tpu_torch.enc.encoder import Encoder
    from thor_tpu_torch.utils.snr import snr_plane
    from tools.gen_torch_enc_goldens import CASES, golden_path, load_frames

    # 1. full width: 3 frames of 1920x1080, all intra, 10 modes
    frames = frames_1080()
    out = out_dir / "enc_1080.bit"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    enc = Encoder(enc_params(ENC_1080))
    t0 = time.perf_counter()
    recons = enc.encode_sequence(frames, str(out))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_calls = read_counters()
    peak = torch.cuda.max_memory_allocated()
    stages = ("search", "scan", "emit", "filters")
    per_frame = []
    for i, ft in enumerate(enc.frame_times):
        per_frame.append(sum(ft[k] for k in stages))
        log(f"[slice] 1080p all-intra encode, frame {i}: {ft['tus']} TUs; "
            + ", ".join(f"{k} {ft[k] * 1e3:.1f} ms" for k in stages)
            + " (host clock, each stage ends in a wait for the device)")
    fps = [1.0 / t for t in per_frame]
    med = sorted(fps)[len(fps) // 2]
    psnr = [snr_plane(f[0], r[0]) for f, r in zip(frames, recons)]
    log(f"[slice] 1080p all-intra encode fps={med:.4f} (median of the "
        f"{len(fps)} frames: {', '.join(f'{x:.4f}' for x in fps)}; spread "
        f"{(max(fps) - min(fps)) / med * 100:.1f} % of the median; the whole "
        f"call, reading back each frame included: {wall:.2f} s); "
        f"{out.stat().st_size} bytes written; PSNR-Y "
        f"{', '.join(f'{x:.3f}' for x in psnr)} dB; "
        f"max_memory_allocated={peak} B; launches {launches}; plain calls "
        f"{plain_calls}; card {card}")
    if launches["encode_scan"] != 2 * len(recons) or len(recons) != 3 \
            or any(plain_calls.values()):
        raise AssertionError("the 1080p encode did not run through "
                             "encode_scan alone, twice per frame")
    zero_counters()
    decode_equals(out, recons, dev, "1080p all-intra stream")
    launches_dec, plain_dec = read_counters()
    if not launches_dec["intra_scan"] or any(plain_dec.values()):
        raise AssertionError("the decode of the encoder's stream did not "
                             "run through the intra scan kernel")

    # 2. CIF through the command line: 4 modes, fast transforms, delta-QP
    cif, rec = out_dir / "enc_cif_fast.bit", out_dir / "enc_cif_fast_rec.yuv"
    zero_counters()
    rc = enc_main(["-if", str(TESTDATA / "test_cif.yuv"), "-of", str(cif),
                   "-rf", str(rec)] + ENC_CIF_FAST)
    l_cif, p_cif = read_counters()
    if rc != 0 or l_cif["encode_scan"] != 4 or any(p_cif.values()):
        raise AssertionError("the CIF command-line encode failed or did not "
                             "run through encode_scan")
    raw = np.frombuffer(rec.read_bytes(), np.uint8).reshape(2, -1)
    cut = (352 * 288, 352 * 288 + 176 * 144)
    decode_equals(cif, [(f[:cut[0]].reshape(288, 352),
                         f[cut[0]:cut[1]].reshape(144, 176),
                         f[cut[1]:].reshape(144, 176)) for f in raw], dev,
                  f"CIF fast-path stream ({cif.stat().st_size} bytes)")

    # 3. thor_tpu's all-intra streams for the same parameters and input,
    # byte for byte (phase_encode_pb holds the P/B ones)
    for name in CASES:
        fields, fr = load_frames(name)
        if fields.get("intra_period") != 1 or not fields["device_encode"]:
            continue
        got = out_dir / f"enc_{name}.bit"
        Encoder(enc_params(fields)).encode_sequence(fr, str(got))
        same = got.read_bytes() == golden_path(name).read_bytes()
        log(f"[slice] {name}: {got.stat().st_size} bytes "
            f"{'equal' if same else 'DIFFER FROM'} thor_tpu's "
            f"{golden_path(name).name}")
        if not same:
            raise AssertionError(f"{name}: the port's stream differs from "
                                 "thor_tpu's")
    return launches


# the LDB form of LDB_medium_complexity_1080.bit's sequence header (two
# references, bipred, deblocking, CLPF, block contexts, no tb / pb split,
# no delta-QP): I P P P, two references from frame 2
ENC_1080_PB = dict(width=1920, height=1080, qp=32, num_frames=4,
                   device_encode=1, max_num_ref=2, enable_bipred=1,
                   deblocking=1, clpf=1, use_block_contexts=1,
                   encoder_speed=0)
PB_STAGES = ("me", "trials", "intra_search", "decide", "second_chance",
             "final", "emit", "filters")


def counted_encoder(base):
    """A subclass of `base` (an Encoder) that sets every launch counter to
    0 just before each frame and reads them just after, with the frame's
    peak device memory: `counts` holds (launches, plain calls, peak B) per
    frame in coding order."""
    class Counted(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.counts = []

        def encode_frame(self, w):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_counters()
            super().encode_frame(w)
            torch.cuda.synchronize()
            self.counts.append((*read_counters(),
                                torch.cuda.max_memory_allocated()))
    return Counted


def phase_encode_pb(dev, card, out_dir):
    """The device encoder's P and B frames. Returns the launches of the
    1080p LDB-form encode (all frames) by kernel."""
    from thor_tpu_torch.enc.encoder import Encoder
    from thor_tpu_torch.utils.profile_encode import ProfiledEncoder
    from thor_tpu_torch.utils.snr import snr_plane
    from tools.gen_torch_enc_goldens import golden_path, load_frames

    # 1. full width: I P P P at 1920x1080, counters and peak memory per
    # frame, then the same encode with every frame under torch.profiler
    frames = frames_1080(4)
    out = out_dir / "enc_1080_pb.bit"
    enc = counted_encoder(Encoder)(enc_params(ENC_1080_PB))
    t0 = time.perf_counter()
    recons = enc.encode_sequence(frames, str(out))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prof = ProfiledEncoder(enc_params(ENC_1080_PB))
    prof_out = out_dir / "enc_1080_pb_prof.bit"
    prof.encode_sequence(frames, str(prof_out))
    if prof_out.read_bytes() != out.read_bytes():
        raise AssertionError("the profiled 1080p P/B encode wrote other "
                             "bytes")
    total = {}
    fps = []
    for i, (ft, (launches, plain, peak), pr) in enumerate(zip(
            enc.frame_times, enc.counts, prof.profiles)):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        psnr = snr_plane(frames[i][0], recons[i][0])
        if i == 0:
            stages = ("search", "scan", "emit", "filters")
            what = f"I frame, {ft['tus']} TUs"
        else:
            stages = PB_STAGES
            what = (f"P frame, {ft['pus']} MC PUs, {ft['intra_leaves']} "
                    f"intra leaves")
            fps.append(1.0 / sum(ft[k] for k in stages))
        busy = sum(pr[1].values())
        log(f"[slice] 1080p LDB-form encode, frame {i} ({what}): "
            + ", ".join(f"{k} {ft[k] * 1e3:.1f} ms" for k in stages)
            + f" (host clock, each stage ends in a wait for the device); "
            f"mc_frame {launches['mc_frame']} / encode_scan "
            f"{launches['encode_scan']} launches; plain calls "
            f"{sum(plain.values())}; {pr[3]} kernel launches in all "
            f"(torch.profiler, profiled run: wall {pr[0]:.1f} ms, device busy "
            f"{busy:.1f} ms, idle {max(0.0, 1 - busy / pr[0]) * 100:.1f} %); "
            f"max_memory_allocated={peak} B; PSNR-Y {psnr:.3f} dB")
        if any(plain.values()):
            raise AssertionError(f"frame {i} called a plain version")
        if i and (launches["mc_frame"] != 2 or not ft["pus"]
                  or bool(launches["encode_scan"]) != bool(ft["intra_leaves"])
                  or launches["encode_scan"] not in (0, 2)):
            raise AssertionError(f"P frame {i} did not reconstruct through "
                                 "mc_frame and (on intra leaves) "
                                 "encode_scan")
    _, groups_p, top_p, _ = prof.profiles[-1]
    log(f"[slice] 1080p LDB-form encode, frame {len(prof.profiles) - 1} "
        f"under torch.profiler (CPU + CUDA activities): device ms by group "
        f"{ {k: round(v, 3) for k, v in groups_p.items()} }; top kernels "
        f"(ms, launches, name) {top_p[:6]}")
    med = sorted(fps)[len(fps) // 2]
    log(f"[slice] 1080p P-frame encode fps={med:.4f} (median of frames "
        f"1-3: {', '.join(f'{x:.4f}' for x in fps)}; spread "
        f"{(max(fps) - min(fps)) / med * 100:.1f} % of the median; host "
        f"clock, the stages' sum; the whole 4-frame call, reading back each "
        f"frame included: {wall:.2f} s); {out.stat().st_size} bytes "
        f"written; launches over the encode {total}; card {card}")
    zero_counters()
    decode_equals(out, recons, dev, "1080p LDB-form stream")
    launches_dec, plain_dec = read_counters()
    if not launches_dec["mc_frame"] or any(plain_dec.values()):
        raise AssertionError("the decode of the encoder's P/B stream did "
                             "not run through the kernels")

    # 2. and 3. thor_tpu's P/B streams byte for byte; the RA one
    # synthesizes its interpolated references through kernels 3-5
    for name, must in (("ldb_qcif", ("mc_frame",)),
                       ("ra_qcif", ("mc_frame", "me_level", "mot_comp",
                                    "mot_comp_uv"))):
        fields, fr = load_frames(name)
        got = out_dir / f"enc_{name}.bit"
        zero_counters()     # the interpolation runs between frames
        Encoder(enc_params(fields)).encode_sequence(fr, str(got))
        launches, plain = read_counters()
        plain = sum(plain.values())
        same = got.read_bytes() == golden_path(name).read_bytes()
        log(f"[slice] {name}: {got.stat().st_size} bytes "
            f"{'equal' if same else 'DIFFER FROM'} thor_tpu's "
            f"{golden_path(name).name}; launches {launches}; plain calls "
            f"{plain}")
        if not same or plain or not all(launches[k] for k in must):
            raise AssertionError(f"{name}: the port's stream differs from "
                                 f"thor_tpu's or skipped a kernel of {must}")
    return total


# ---------------------------------------------------------------------------
# the host mirror encoder (device_encode=0)
# ---------------------------------------------------------------------------

SYNTH = ("me_level", "mot_comp", "mot_comp_uv")


def counted_gate(path, recons, dev, what, must):
    """The decode gate with every counter set to 0 just before and read
    just after: the port's decoder reads `path` back to `recons` through
    the kernels in `must` and no plain version."""
    zero_counters()
    decode_equals(path, recons, dev, what)
    launches, plain = read_counters()
    if not all(launches[k] for k in must) or any(plain.values()):
        raise AssertionError(f"{what}: the decode did not run through the "
                             f"kernels {must} alone")
    return launches


def split_and_resume(name, out_dir):
    """Encode case `name` in two parts, a snapshot after frame 1 and a
    fresh Encoder resuming from it; the stream must be the golden."""
    from thor_tpu_torch.enc.encoder import Encoder
    from tools.gen_torch_enc_goldens import golden_path, load_frames
    fields, fr = load_frames(name)
    out, ckpt = out_dir / f"split_{name}.bit", out_dir / f"{name}.npz"
    t0 = time.perf_counter()
    Encoder(enc_params(dict(fields, num_frames=2))).encode_sequence(
        fr, str(out), checkpoint_path=str(ckpt), checkpoint_every=2)
    Encoder(enc_params(fields)).encode_sequence(fr, str(out),
                                                resume_path=str(ckpt))
    same = out.read_bytes() == golden_path(name).read_bytes()
    log(f"[slice] {name} split after frame 1 and resumed from "
        f"{ckpt.stat().st_size} B of snapshot: {out.stat().st_size} bytes "
        f"{'equal' if same else 'DIFFER FROM'} {golden_path(name).name} "
        f"({time.perf_counter() - t0:.1f} s)")
    if not same:
        raise AssertionError(f"{name}: the resumed stream differs")


def phase_encode_host(dev, card, out_dir):
    """The host mirror encoder: the block search in numpy on the host, the
    filters, the reference window and the interpolated reference on the
    card. Each thor_tpu mirror golden byte for byte, with every counter
    read around each encode (the RA case synthesizes its interpolated
    references through kernels 3-5) and around its decode gate; the
    stage times of every frame, the CIF P-frame fps, one profiled CIF
    frame; a split and resumed encode of the mirror and of the device
    encoder. Returns the launches over the four mirror encodes by
    kernel."""
    from thor_tpu_torch.enc.encoder import Encoder
    from thor_tpu_torch.utils.profile_decode import profile_run
    from tools.gen_torch_enc_goldens import CASES, golden_path, load_frames

    t_phase = time.perf_counter()
    total = {}
    for name in [n for n, c in CASES.items() if not c[2]["device_encode"]]:
        fields, fr = load_frames(name)
        got = out_dir / f"enc_{name}.bit"
        zero_counters()     # the interpolation runs between frames
        enc = Encoder(enc_params(fields))
        t0 = time.perf_counter()
        recons = enc.encode_sequence(fr, str(got))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, plain = read_counters()
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        same = got.read_bytes() == golden_path(name).read_bytes()
        interp = bool(fields.get("interp_ref"))
        log(f"[slice] host mirror {name}: {got.stat().st_size} bytes "
            f"{'equal' if same else 'DIFFER FROM'} thor_tpu's "
            f"{golden_path(name).name}; {len(recons)} frames in {wall:.2f} s "
            f"(the whole call); launches {launches}; plain calls "
            f"{sum(plain.values())}; card {card}")
        for i, ft in enumerate(enc.frame_times):
            log(f"[slice] host mirror {name}, coded frame {i}: search "
                f"{ft['search']:.3f} s (host numpy), filters "
                f"{ft['filters'] * 1e3:.2f} ms (device; each stage ends in "
                f"a wait for the device)")
        if name == "host_ldb_cif":
            fps = [1.0 / (ft["search"] + ft["filters"])
                   for ft in enc.frame_times]
            mean = len(fps) / sum(1 / x for x in fps)
            log(f"[slice] host mirror CIF fps={mean:.4f} over the "
                f"{len(fps)} frames (I frame {fps[0]:.4f}, P frames "
                f"{', '.join(f'{x:.4f}' for x in fps[1:])}: one reference, "
                f"then two with bipred; host clock, search + filters); "
                f"card {card}")
        if not same or any(plain.values()) \
                or any(launches[k] for k in launches if k not in SYNTH) \
                or interp != all(launches[k] for k in SYNTH):
            raise AssertionError(f"{name}: the mirror's stream differs from "
                                 "thor_tpu's, or its kernels are not the "
                                 "synthesis' alone, on RA only")
        must = ("intra_scan",) + (("mc_frame",) if len(recons) > 1 else ()) \
            + (SYNTH if interp else ())
        counted_gate(got, recons, dev, f"host mirror {name} stream", must)

    # one CIF P frame (frame 1 of host_ldb_cif) under torch.profiler
    class OneProfiled(Encoder):
        def encode_frame(self, w):
            if self.frame_num != 1:
                return super().encode_frame(w)
            self.profile = profile_run(lambda: Encoder.encode_frame(self, w))

    fields, fr = load_frames("host_ldb_cif")
    got = out_dir / "enc_host_ldb_cif_prof.bit"
    prof = OneProfiled(enc_params(dict(fields, num_frames=2)))
    prof.encode_sequence(fr, str(got))
    _, wall, groups, top, n_launch = prof.profile
    busy = sum(groups.values())
    prefix = golden_path("host_ldb_cif").read_bytes().startswith(
        got.read_bytes())
    log(f"[slice] host mirror CIF P frame 1 under torch.profiler (CPU + "
        f"CUDA activities): wall {wall:.1f} ms, device busy {busy:.3f} ms, "
        f"idle {max(0.0, 1 - busy / wall) * 100:.3f} %; {n_launch} kernel "
        f"launches; device ms by group "
        f"{ {k: round(v, 3) for k, v in groups.items()} }; top kernels "
        f"(ms, launches, name) {top[:5]}; the stream is "
        f"{'the' if prefix else 'NOT the'} golden's first two frames; "
        f"card {card}")
    if not prefix:
        raise AssertionError("the profiled mirror encode wrote other bytes")

    for name in ("host_ldb_qcif", "ldb_qcif"):
        split_and_resume(name, out_dir)
    log(f"[slice] host mirror phase: {time.perf_counter() - t_phase:.1f} s "
        f"in all (host clock); card {card}")
    return total


# ---------------------------------------------------------------------------
# the parallel paths: ShardedDecoder over a gop x tile mesh of streams, two
# wavefronts at once, two processes on the card, ShardedEncoder
# ---------------------------------------------------------------------------

SHARDED_MESHES = ((1, 1), (2, 1), (4, 1), (2, 2), (1, 4))
DEC_KERNELS = ("mc_frame", "intra_scan") + SYNTH
ENC_KERNELS = ("mc_frame", "encode_scan") + SYNTH
RA_FORM = dict(width=1920, height=1080, num_frames=5, qp=32, device_encode=1,
               max_num_ref=2, enable_bipred=1, num_reorder_pics=3,
               interp_ref=1, use_block_contexts=1, encoder_speed=0)


def golden_sha(path):
    return path.with_name(path.stem + "_dec.sha256").read_text().split()[0]


def sharded_decode(path, gop, tile):
    """(frames, sha256, level sizes) of one ShardedDecoder decode on the
    card (gop x tile slots as streams of the one card); fails if an MC
    window left the padded plane."""
    from thor_tpu_torch.parallel.stream import ShardedDecoder
    sd = ShardedDecoder(gop=gop, tile=tile)
    h = hashlib.sha256()
    n = 0
    for planes in sd.iter_frames(str(path)):
        for p in planes:
            h.update(p.tobytes())
        n += 1
    if sd.mc_clamped:
        raise AssertionError(f"{path.name}: MC windows left the padded "
                             "reference plane")
    return n, h.hexdigest(), list(sd.last_level_sizes)


def counted_sharded(path, gop, tile, must, levels, card):
    """One sharded decode with every counter set to 0 just before and read
    just after: the golden's sha256, thor_tpu's level sizes, the kernels in
    `must` launched and no plain version called. Returns the launches."""
    zero_counters()
    n, sha, lv = sharded_decode(path, gop, tile)
    launches, plain = read_counters()
    ok = (sha == golden_sha(path) and lv == levels[path.stem]
          and all(launches[k] for k in must) and not any(plain.values()))
    log(f"[parallel] {path.name} mesh {gop}x{tile} ({gop * tile} streams on "
        f"one card): {n} frames sha256 {'matches' if ok else 'DIFFERS'}; "
        f"levels {lv} (thor_tpu: {levels[path.stem]}); launches {launches}; "
        f"plain calls {sum(plain.values())}; card {card}")
    if not ok:
        raise AssertionError(f"{path.name} at {gop}x{tile}: golden, levels "
                             f"or kernels {must} wrong")
    return launches


def timed_sharded(path, gop, tile):
    """fps of one warm sharded decode, host clock ending in
    torch.cuda.synchronize(), the sha256 checked."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n, sha, _ = sharded_decode(path, gop, tile)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if sha != golden_sha(path):
        raise AssertionError(f"timed sharded decode of {path.name} differs")
    return n / dt


def timed_decoder(path, dev):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n, sha, _ = decode(path, dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if sha != golden_sha(path):
        raise AssertionError(f"timed decode of {path.name} differs")
    return n / dt


def stream_overlap(trace_path):
    """From a torch.profiler chrome trace: (device busy ms: the union of
    kernel, copy and memset intervals; ms in which kernels of two or more
    streams run at once; kernel launches; streams with kernels)."""
    events = json.loads(Path(trace_path).read_text())["traceEvents"]
    gpu = [e for e in events if e.get("ph") == "X" and e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset")]

    def union(iv):
        out = []
        for a, b in sorted(iv):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    busy = sum(b - a for a, b in union(
        [(e["ts"], e["ts"] + e["dur"]) for e in gpu]))
    by_stream = {}
    for e in gpu:
        if e["cat"] == "kernel":
            by_stream.setdefault(e["args"].get("stream"), []).append(
                (e["ts"], e["ts"] + e["dur"]))
    edges = []
    for iv in by_stream.values():
        for a, b in union(iv):
            edges += [(a, 1), (b, -1)]
    edges.sort()
    overlap, depth, last = 0.0, 0, None
    for t, d in edges:
        if depth >= 2:
            overlap += t - last
        depth += d
        last = t
    launches = sum(len(v) for v in by_stream.values())
    return busy / 1e3, overlap / 1e3, launches, len(by_stream)


def profiled_sharded(out_dir, levels, dev, card):
    """One 4x1 RA16 decode under torch.profiler (CPU + CUDA), and one
    Decoder decode counted the same way: device busy and idle share, the
    ms in which kernels of two or more streams overlap, the launches."""
    from torch.profiler import ProfilerActivity, profile
    runs = (("ShardedDecoder 4x1",
             lambda: sharded_decode(STREAM_RA_1080, 4, 1)[1:]),
            ("Decoder", lambda: (decode(STREAM_RA_1080, dev)[1],
                                 levels[STREAM_RA_1080.stem])))
    for what, run in runs:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sha, lv = run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        trace = out_dir / "profile.json"
        prof.export_chrome_trace(str(trace))
        busy, overlap, launches, streams = stream_overlap(trace)
        log(f"[parallel] {STREAM_RA_1080.name} {what} under torch.profiler: "
            f"wall {wall:.1f} ms, device busy {busy:.3f} ms, idle "
            f"{max(0.0, 1 - busy / wall) * 100:.2f} %; kernels of two or "
            f"more streams overlap for {overlap:.3f} ms "
            f"({overlap / busy * 100:.2f} % of busy); {launches} kernel "
            f"launches on {streams} streams; card {card}")
        if sha != golden_sha(STREAM_RA_1080) or \
                lv != levels[STREAM_RA_1080.stem]:
            raise AssertionError(f"the profiled {what} decode differs")


def two_wavefronts(dev, card, repeats=20):
    """Kernels 1 (the 1080p I frame's Y and U+V records) and 3 (level 0 of
    the first interpolated 1080p frame) each on two streams at once,
    `repeats` times; every result equals the plain version."""
    from thor_tpu_torch.dec.reconstruct import residual_planes
    from thor_tpu_torch.ops import interp as TI
    from thor_tpu_torch.ops import intra as IT

    _, _, (cfg0, inp0), _ = first_frames(dev)
    H, W = cfg0.H, cfg0.W
    ry, rc = residual_planes(cfg0, inp0, dev)
    scans = (((torch.zeros((1, H, W), dtype=torch.int32, device=dev),
               ry[None].contiguous(), inp0["it_y"])),
             (torch.zeros((2, H // 2, W // 2), dtype=torch.int32,
                          device=dev), rc, inp0["it_c"]))
    calls = []
    r0, r1, ratio, pos = first_interp_pair(dev)
    TI.level0_motion(r0, r1, ratio, pos, on_level=lambda *c: calls.append(c))
    _, a0, kw0, _ = calls[-1]
    assert kw0["w"] == W and kw0["h"] == H
    jobs = {"intra_scan": (lambda k: IT.intra_scan(*scans[k]),
                           [IT.intra_scan_plain(*sc) for sc in scans]),
            "me_level": (lambda k: TI.me_level(*a0, **kw0),
                         [TI.me_level_plain(*a0, **kw0)] * 2)}
    streams = (torch.cuda.Stream(dev), torch.cuda.Stream(dev))
    for kname, (run, want) in jobs.items():
        t0 = time.perf_counter()
        equal = 0
        for _ in range(repeats):
            ready = torch.cuda.Event()
            ready.record()
            outs = []
            for k, s in enumerate(streams):
                s.wait_event(ready)
                with torch.cuda.stream(s):
                    outs.append(run(k))
            torch.cuda.synchronize()
            equal += all(
                all(torch.equal(g, w) for g, w in zip(
                    o if isinstance(o, tuple) else (o,),
                    v if isinstance(v, tuple) else (v,)))
                for o, v in zip(outs, want))
        log(f"[parallel] {kname} on two streams at once "
            f"({'Y and U+V of the 1080p I frame' if kname == 'intra_scan' else 'level 0 of the first interpolated 1080p frame, twice'}):"
            f" {equal} of {repeats} equal to the plain version "
            f"({time.perf_counter() - t0:.2f} s host clock); card {card}")
        if equal != repeats:
            raise AssertionError(f"{kname}: two at once differ from plain")


def two_processes(card):
    """parallel/worker.py in two processes on the one card (gloo carries
    host planes): LDB_low_complexity, each process gop row of a 2x1 mesh;
    both must print DIST_OK with the golden's sha256."""
    import socket
    gold = TESTDATA / "LDB_low_complexity_dec.yuv"
    want = hashlib.sha256(gold.read_bytes()).hexdigest()
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        coord = f"localhost:{sk.getsockname()[1]}"
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "thor_tpu_torch.parallel.worker", coord, "2",
         str(pid), str(TESTDATA / "LDB_low_complexity.bit"), str(gold)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=str(HERE)) for pid in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ok = all(p.returncode == 0 and f"DIST_OK {want}" in o
             for p, o in zip(procs, outs))
    log(f"[parallel] two processes (gloo, one card) on LDB_low_complexity: "
        f"{'both DIST_OK ' + want if ok else 'FAILED'} "
        f"({time.perf_counter() - t0:.1f} s with start-up); card {card}")
    if not ok:
        raise AssertionError("two-process decode failed:\n"
                             + "\n".join(o[-2000:] for o in outs))


def sharded_encode(params, frames, out, slots=2):
    """(reconstructions, seconds, ShardedEncoder) of one encode on `slots`
    streams of the card."""
    from thor_tpu_torch.parallel.encode import ShardedEncoder
    se = ShardedEncoder(params, devices=["cuda:0"] * slots)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = se.encode_sequence(frames, str(out))
    torch.cuda.synchronize()
    return rec, time.perf_counter() - t0, se


def phase_parallel(dev, card, out_dir):
    """The parallel paths on the one card. Returns the launches of the 4x1
    RA16 decode and of the 1080p RA-form sharded encode by kernel."""
    from thor_tpu_torch.enc.encoder import Encoder
    from tools.gen_torch_enc_goldens import golden_path, load_frames
    from tools.gen_torch_levels import load_levels

    t_phase = time.perf_counter()
    levels = load_levels()
    launches_ra = {}
    for gop, tile in SHARDED_MESHES:
        launches_ra[gop, tile] = counted_sharded(STREAM_RA_1080, gop, tile,
                                                 DEC_KERNELS, levels, card)
    # tile 1 is reconstruct_frame: the Decoder's launches, on any gop
    _, _, launches_dec = counted_decode(STREAM_RA_1080, dev, DEC_KERNELS)
    if not launches_ra[1, 1] == launches_ra[2, 1] == launches_ra[4, 1] \
            == launches_dec:
        raise AssertionError("a tile-1 sharded decode launched other "
                             "kernels than the Decoder")
    fps = {"Decoder": []}
    for _ in range(FPS_REPEATS):
        fps["Decoder"].append(timed_decoder(STREAM_RA_1080, dev))
        for m in ((1, 1), (4, 1)):
            fps.setdefault(m, []).append(timed_sharded(STREAM_RA_1080, *m))
    for m in SHARDED_MESHES:
        if m not in fps:
            fps[m] = [timed_sharded(STREAM_RA_1080, *m)]
    for k, v in fps.items():
        med = sorted(v)[len(v) // 2]
        what = "Decoder (native route, pipelined)" if k == "Decoder" \
            else f"ShardedDecoder {k[0]}x{k[1]}"
        log(f"[parallel] {STREAM_RA_1080.name} {what}: fps={med:.3f} "
            f"({len(v)} warm decodes: {', '.join(f'{x:.3f}' for x in v)}; "
            f"host clock, each ends in torch.cuda.synchronize()); card "
            f"{card}")
    for m in ((1, 2), (1, 4)):
        counted_sharded(STREAM_1080, *m, ("mc_frame", "intra_scan"), levels,
                        card)
    profiled_sharded(out_dir, levels, dev, card)

    # RA16_long at 4x2 (8 streams) through the CLI
    out = out_dir / "ra16_long.yuv"
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "thor_tpu_torch.dec",
                        str(TESTDATA / "RA16_long.bit"), str(out), "--mesh",
                        "4x2"], capture_output=True, text=True, cwd=str(HERE),
                       timeout=300)
    line = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    lv = json.loads(line.split("gop-level batches=")[1][:-1]) \
        if "gop-level batches=" in line else []
    ok = (r.returncode == 0 and out.exists()
          and hashlib.sha256(out.read_bytes()).hexdigest()
          == (TESTDATA / "RA16_long_dec.sha256").read_text().split()[0]
          and lv == levels["RA16_long"] and max(lv) >= 8)
    log(f"[parallel] RA16_long via `python -m thor_tpu_torch.dec --mesh "
        f"4x2`: {line!r}; output {'matches' if ok else 'DIFFERS FROM'} its "
        f"sha256; widest level {max(lv) if lv else None} "
        f"({time.perf_counter() - t0:.1f} s with start-up); card {card}")
    if not ok:
        raise AssertionError(f"RA16_long --mesh 4x2 failed:\n{r.stdout}\n"
                             f"{r.stderr[-3000:]}")

    two_wavefronts(dev, card)
    two_processes(card)

    # ShardedEncoder on two streams: the thor_tpu streams byte for byte
    for name in ("ldb_qcif", "ra_qcif"):
        fields, fr = load_frames(name)
        zero_counters()
        _, dt, _ = sharded_encode(enc_params(fields), fr,
                                  out_dir / f"par_{name}.bit")
        launches, plain = read_counters()
        must = ("mc_frame", "encode_scan") + (SYNTH if name == "ra_qcif"
                                              else ())
        same = (out_dir / f"par_{name}.bit").read_bytes() == \
            golden_path(name).read_bytes()
        log(f"[parallel] ShardedEncoder (2 streams) {name}: "
            f"{'equal to' if same else 'DIFFERS FROM'} "
            f"{golden_path(name).name}; {dt:.2f} s; launches {launches}; "
            f"plain calls {sum(plain.values())}")
        if not same or not all(launches[k] for k in must) \
                or any(plain.values()):
            raise AssertionError(f"ShardedEncoder {name} failed")

    # the 1080p RA form: sequential Encoder, then ShardedEncoder
    fr = frames_1080(RA_FORM["num_frames"])
    seq_out, par_out = out_dir / "ra_form_seq.bit", out_dir / "ra_form.bit"
    enc = Encoder(enc_params(RA_FORM))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec_seq = enc.encode_sequence(fr, str(seq_out))
    torch.cuda.synchronize()
    dt_seq = time.perf_counter() - t0
    zero_counters()
    rec, dt, se = sharded_encode(enc_params(RA_FORM), fr, par_out)
    launches_enc, plain = read_counters()
    same = seq_out.read_bytes() == par_out.read_bytes() and all(
        np.array_equal(a, b) for x, y in zip(rec, rec_seq)
        for a, b in zip(x, y)) and len(rec) == len(rec_seq) == 5
    for what, e, t in (("Encoder", enc, dt_seq), ("ShardedEncoder", se.enc,
                                                  dt)):
        log(f"[parallel] 1080p RA-form encode, {what}: {t:.3f} s for 5 "
            f"frames ({5 / t:.4f} fps, host clock); stages (s) by coded "
            f"frame: " + "; ".join(
                f"{i}: " + ", ".join(f"{k} {v:.3f}" for k, v in ft.items()
                                     if isinstance(v, float))
                for i, ft in enumerate(e.frame_times)))
    log(f"[parallel] 1080p RA-form ShardedEncoder (2 streams): "
        f"{par_out.stat().st_size} bytes {'equal to' if same else 'DIFFER FROM'}"
        f" the sequential Encoder's; launches {launches_enc}; plain calls "
        f"{sum(plain.values())}; card {card}")
    if not same or not all(launches_enc[k] for k in ENC_KERNELS) \
            or any(plain.values()):
        raise AssertionError("the 1080p RA-form ShardedEncoder differs from "
                             "the Encoder or missed its kernels")
    decode_equals(par_out, rec, dev, "1080p RA-form sharded encode")
    log(f"[parallel] parallel phase: {time.perf_counter() - t_phase:.1f} s "
        f"in all (host clock); card {card}")
    return launches_ra[4, 1], launches_enc


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import thor_tpu_torch  # noqa: F401  (fails outside a repo checkout)

    dev = torch.device("cuda")
    smi_line, card = phase_device()
    phase_build()
    rows, max_err = phase_kernels(dev)
    rows_i, max_err_i = phase_interp_kernels(dev)
    rows_e, max_err_e = phase_enc_kernel(dev)
    phase_edge_shapes(dev)
    for r, e in ((rows_i, max_err_i), (rows_e, max_err_e)):
        rows.update(r)
        max_err.update(e)
    ldb = ("mc_frame", "intra_scan")
    launches, nframes = phase_slice(STREAM_1080, ldb, CIF_STREAMS, dev, card)
    launches_ra, _ = phase_slice(
        STREAM_RA_1080, ldb + ("me_level", "mot_comp", "mot_comp_uv"),
        CIF_INTERP_STREAMS + ("RA16_long",), dev, card)
    launches_py_ldb, launches_py_ra = phase_python_route(dev, card)
    with tempfile.TemporaryDirectory() as tmp:
        launches_enc = phase_encode(dev, card, Path(tmp))
        launches_pb = phase_encode_pb(dev, card, Path(tmp))
        launches_host = phase_encode_host(dev, card, Path(tmp))
        launches_sh_ra, launches_sh_enc = phase_parallel(dev, card, Path(tmp))

    pi = "thor_tpu/ops/pallas_interp.py"
    meta = {
        "mc_frame": ("thor_tpu_torch/csrc/mc.cu",
                     "thor_tpu/ops/pallas_mc.py:88"),
        "intra_scan": ("thor_tpu_torch/csrc/intra_scan.cu",
                       "thor_tpu/ops/pallas_intra.py:283"),
        "me_level": ("thor_tpu_torch/csrc/interp_me.cu", f"{pi}:110"),
        "mot_comp": ("thor_tpu_torch/csrc/interp_mc.cu", f"{pi}:455"),
        "mot_comp_uv": ("thor_tpu_torch/csrc/interp_mc.cu", f"{pi}:510"),
        "encode_scan": ("thor_tpu_torch/csrc/enc_intra_scan.cu",
                        "thor_tpu/ops/pallas_enc_intra.py:278"),
    }
    kernels = []
    for name, (src, repl) in meta.items():
        r = rows[name]             # the launches one frame makes
        b_ms, b_by = bound_ms(sum(x[4][0] for x in r),
                              sum(x[4][1] for x in r))
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": (launches if name in ldb else launches_enc
                         if name == "encode_scan" else launches_ra)[name],
            "launches_ra16_path": launches_ra[name],
            "launches_python_parse_ldb": launches_py_ldb[name],
            "launches_python_parse_ra16": launches_py_ra[name],
            **({"launches_pb_encode": launches_pb[name]}
               if name in ("mc_frame", "encode_scan") else {}),
            "launches_host_encode": launches_host[name],
            "launches_sharded_ra16": launches_sh_ra[name],
            "launches_sharded_encode": launches_sh_enc[name],
            "max_abs_err": max_err[name],
            "ms": sum(x[0] for x in r), "plain_ms": sum(x[1] for x in r),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    log(f"[summary] ms / plain_ms / bound_ms are per frame at the 1080p "
        f"shapes: mc_frame and intra_scan one Y and one U/V launch, "
        f"me_level its four pyramid levels, mot_comp and mot_comp_uv one "
        f"launch each, writing the padded planes, encode_scan one Y and one "
        f"U/V launch at the 1080p I frame; launches: mc_frame and "
        f"intra_scan over the {nframes}-frame LDB decode, the interpolation "
        f"kernels over the {nframes}-frame "
        f"RA16 decode (launches_ra16_path: those five there; "
        f"launches_python_parse_ldb / _ra16: each kernel over the "
        f"collect_stats decodes of the two 1080p streams, Python parse), "
        f"encode_scan "
        f"over the 3-frame 1080p all-intra encode (launches_pb_encode: "
        f"mc_frame and encode_scan over the 4-frame 1080p LDB-form encode; "
        f"launches_host_encode: each kernel over the four host mirror "
        f"encodes, the synthesis on host_ra_qcif; launches_sharded_ra16: "
        f"each kernel over the 4x1 ShardedDecoder decode of RA16; "
        f"launches_sharded_encode: each kernel over the 1080p RA-form "
        f"ShardedEncoder encode on two streams); {smi_line}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
