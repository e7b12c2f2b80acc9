"""Synthetic frame inputs for benchmarks and checks.

Counterpart of thor_tpu/utils/synth.py: an inter frame for the frame
program (dec/reconstruct.reconstruct_frame) with a plausible coding
density (a 16x16-coherent MV field, residual TUs of 4, 8 and 16 on a
quarter of the 16x16 cells, CLPF on part of the frame) without a parsed
stream. The draws are thor_tpu's, in its order, from the same
numpy RandomState, so one seed gives both packages the same frame; they
are laid out as the port's frame program reads them: the MV field as MC
records (ops/mc.build_mc_records, one PU per 16x16 cell), the residual
groups sparse as dec/inputs packs them, no intra TU, the side-info map
packed by ops/kernels.pack_ddp, and R random codec-padded references.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codec.constants import (BETA_TABLE, CHROMA_QP, GDEQUANT_TABLE, PAD_C,
                               PAD_Y, TC_TABLE, log2i)
from ..dec.decoder import RefFrame
from ..dec.inputs import FrameConfig
from ..dec.reconstruct import to_device
from ..device import resolve_device
from ..ops.kernels import pack_ddp
from ..ops.mc import build_mc_records


def _dq(qp, tsize):
    factor = int(GDEQUANT_TABLE[qp % 6]) << (qp // 6)
    rshift = log2i(tsize) - 1
    return factor, 1 << (rshift - 1), rshift


def _tu_group(rng, positions, s, qp, nnz=6, chroma=False):
    """thor_tpu's draws of one TU group, packed sparse as
    dec/inputs._pack_sparse packs a group: {cidx, cval, y, x, f, a, sh[,
    pl]}."""
    n = len(positions)
    coeff = np.zeros((n, s, s), np.int16)
    qs = min(s, 16)
    for i in range(n):
        k = rng.randint(1, nnz + 1)
        ys = rng.randint(0, max(qs // 2, 1), k)
        xs = rng.randint(0, max(qs // 2, 1), k)
        coeff[i, ys, xs] = rng.randint(-30, 31, k).astype(np.int16)
    f, a, sh = _dq(qp, s)
    flat = coeff.reshape(-1)
    cidx = np.flatnonzero(flat)
    g = {"cidx": cidx.astype(np.int64), "cval": flat[cidx].astype(np.int32),
         "y": np.array([p[0] for p in positions], np.int32),
         "x": np.array([p[1] for p in positions], np.int32),
         "f": np.full(n, f, np.int32), "a": np.full(n, a, np.int32),
         "sh": np.full(n, sh, np.int32)}
    if chroma:
        g["pl"] = rng.randint(0, 2, n).astype(np.int32)
    return g


def build_synthetic_frame(W, H, R=2, qp=32, seed=7, coded_fraction=0.25,
                          device=None):
    """Synthetic inter frame at (W, H) with R references: (FrameConfig,
    inputs on `device`, the R references as dec/decoder.RefFrame). The
    frame has no bipred cells; its MC LUTs are mc_luts(0, device)."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    inp = {}

    refY = rng.randint(0, 256, (R, H + 2 * PAD_Y, W + 2 * PAD_Y)) \
        .astype(np.uint8)
    refU = rng.randint(0, 256, (R, H // 2 + 2 * PAD_C, W // 2 + 2 * PAD_C)) \
        .astype(np.uint8)
    refV = rng.randint(0, 256, (R, H // 2 + 2 * PAD_C, W // 2 + 2 * PAD_C)) \
        .astype(np.uint8)

    # MV field, block-coherent at 16x16: one PU per 16x16 cell, cut at the
    # frame's edge
    cgh, cgw = -(-H // 16), -(-W // 16)
    mvx16 = rng.randint(-64, 65, (cgh, cgw)).astype(np.int32)
    mvy16 = rng.randint(-64, 65, (cgh, cgw)).astype(np.int32)
    slot16 = rng.randint(0, R, (cgh, cgw)).astype(np.int32)
    y0 = np.repeat(np.arange(cgh) * 16, cgw).astype(np.int64)
    x0 = np.tile(np.arange(cgw) * 16, cgh).astype(np.int64)
    zero = np.zeros(cgh * cgw, np.int64)
    pus = {"y0": y0, "x0": x0, "h": np.minimum(16, H - y0),
           "w": np.minimum(16, W - x0), "slot0": slot16.reshape(-1),
           "mvx0": mvx16.reshape(-1), "mvy0": mvy16.reshape(-1), "bi": zero,
           "slot1": zero, "mvx1": zero, "mvy1": zero}
    inp["mc_y"], _ = build_mc_records(pus, H, W, PAD_Y, 2, -2, 6)
    pus_c = dict(pus)
    for k in ("y0", "x0", "h", "w"):
        pus_c[k] = pus[k] // 2
    inp["mc_c"], _ = build_mc_records(pus_c, H // 2, W // 2, PAD_C, 3, -1, 4)

    # residual TUs on a 16-aligned grid, split across sizes 4 / 8 / 16
    cells = [(r * 16, c * 16) for r in range(H // 16) for c in range(W // 16)]
    rng.shuffle(cells)
    ncoded = int(len(cells) * coded_fraction)
    coded = cells[:ncoded]
    n16 = ncoded // 2
    n8 = ncoded // 4
    qpc = int(CHROMA_QP[qp])
    groups = {"gy16": _tu_group(rng, coded[:n16], 16, qp),
              "gy8": _tu_group(rng, coded[n16:n16 + n8], 8, qp),
              "gy4": _tu_group(rng, coded[n16 + n8:], 4, qp)}
    ccoded = [(y // 2, x // 2) for (y, x) in coded]
    groups["gc8"] = _tu_group(rng, ccoded[:n16], 8, qpc, chroma=True)
    groups["gc4"] = _tu_group(rng, ccoded[n16:], 4, qpc, chroma=True)
    inp.update({k: g for k, g in groups.items() if len(g["y"])})

    # side-info map of the deblocking
    gh, gw = H // 4, W // 4

    def cells4(a16):
        return np.repeat(np.repeat(a16, 4, 0), 4, 1)[:gh, :gw]

    cbp16 = (rng.rand(cgh, cgw) < coded_fraction).astype(np.int32)
    zero4 = np.zeros((gh, gw), np.int32)
    inp["ddp"] = pack_ddp({
        "size": np.full((gh, gw), 16, np.int32), "tb_split": zero4,
        "pb_part": zero4, "mode": np.full((gh, gw), 2, np.int32),
        "cbp_y": cells4(cbp16), "mv0x": cells4(mvx16),
        "mv0y": cells4(mvy16), "mv1x": zero4, "mv1y": zero4})
    inp["beta"] = int(BETA_TABLE[qp])
    inp["tc"] = int(TC_TABLE[qp])
    inp["tcC"] = int(TC_TABLE[qpc])

    inp["m8y"] = rng.rand(H // 8, W // 8) < 0.3
    inp["m8u"] = rng.rand(H // 8, W // 8) < 0.15
    inp["m8v"] = rng.rand(H // 8, W // 8) < 0.15

    cfg = FrameConfig(W=W, H=H, R=R, deblocking=True, clpf=True)
    refs = [RefFrame(*(torch.from_numpy(p[r]).to(dev)
                       for p in (refY, refU, refV)), 0) for r in range(R)]
    return cfg, to_device(inp, dev), refs
