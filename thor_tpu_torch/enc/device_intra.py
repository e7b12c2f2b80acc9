"""Batched device intra encoder: the I-frame path of the device encoder.

Counterpart of thor_tpu/enc/device_intra.py. Instead of the reference's
per-block trial coding with stream rewinds, the mode and split search
runs as batched tensor programs over all blocks of the frame at once, on
original-pixel prediction references (the standard fast-encoder
approximation; only the search uses it, the final coding pass
reconstructs exactly). The stream is valid Thor; its RD decisions are
deterministic and equal to thor_tpu's, not to the C encoder's.

Per I frame:
 1. search (device, batched): for each block size 8..64 and every intra
    mode: predict -> residual -> forward transform -> quantize ->
    reconstruct -> SSD + lambda * exact bits; best mode and cost per size.
    All modes of a size (and U with V) go through the quantizer and the
    bit counter as one batch.
 2. split decisions (host, tiny): bottom-up quadtree min-cost reduction.
 3. final pass (device, ops/enc_intra.encode_scan: the CUDA kernel on a
    card): exact reconstruction in coding order, emitting the quantized
    coefficients.
 4. syntax emission (host) through the exact bitstream writers.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..codec.blockdata import find_block_contexts
from ..codec.constants import CBP_TABLE, CHROMA_QP, MODE_INTRA, zigzag_for
from ..dec.inputs import _downleft_available_v, _upright_available_v
from ..ops import kernels as K
from ..ops.coeff_bits import coeff_bits_batch
from ..ops.enc_intra import encode_scan
from ..ops.intra import _predict, build_intra_records
from .block import BlockInfo, BlockParam
from .syntax import (INTRA_LEN_8, INTRA_LEN_10, INTRA_MODE_MAP_8,
                     INTRA_MODE_MAP_10, write_block, write_delta_qp,
                     write_super_mode)

I32 = torch.int32


# ---------------------------------------------------------------------------
# Search pass
# ---------------------------------------------------------------------------

def _intra_mode_bits(nmodes: int):
    """Signalling bits per intra mode (write_block intra branch,
    enc/write_bits.c:418-437)."""
    if nmodes <= 4:
        return [2] * max(nmodes, 4)
    if nmodes <= 8:
        return [INTRA_LEN_8[INTRA_MODE_MAP_8[m]] for m in range(8)]
    return [INTRA_LEN_10[INTRA_MODE_MAP_10[m]] for m in range(10)]


# quote_vlc(0, code) per cbp = y + 2u + 4v, ignoring the swap of codes
# 0 <-> 1 under block_context.cbp == 0 (unknown at search time; +-1 bit,
# the same across the modes of a block most of the time)
_CBP_BITS = tuple((c + 1) if c < 6 else 7 for c in CBP_TABLE)


def _block_grid(s, W, H):
    """Origins of the full s x s blocks of a W x H plane, raster order."""
    HB, WB = H // s, W // s
    ty = np.repeat(np.arange(HB) * s, WB).astype(np.int32)
    tx = np.tile(np.arange(WB) * s, HB).astype(np.int32)
    return ty, tx


def _block_refs_dev(P, s, W, H, up_av, dl_av):
    """Per-block top / left / top-left references of the original-pixel
    search, built from the plane with strided windows: ([N, 128] top,
    [N, 128] left, [N] top-left) for the N full s x s blocks in raster
    order, with make_top_and_left's edge semantics (replication past the
    available length, 128 at the frame's top / left edge).
    up_av / dl_av: [N] bool arrays."""
    dev = P.device
    HB, WB = H // s, W // s
    N = HB * WB
    # one row / column of edge padding before the plane (the reference
    # row above and column left of each block) and s + 2 behind it for the
    # windows of the last blocks
    ri = torch.clamp(torch.arange(-1, H + s + 2, device=dev), 0, H - 1)
    ci = torch.clamp(torch.arange(-1, W + s + 2, device=dev), 0, W - 1)
    Pp = P.to(I32)[ri][:, ci]
    RA = Pp[0:HB * s:s]                  # [HB, *]: the row above a block row
    CA = Pp[:, 0:WB * s:s]               # [*, WB]: the column left of it

    def windows(M, nblk):
        # [n_other, nblk, s + 1]: window b holds M[:, 1 + b*s + (0..s)]
        return M[:, 1:nblk * s + 2].unfold(1, s + 1, s)

    topw = windows(RA, WB).reshape(N, s + 1)
    leftw = windows(CA.t(), HB).permute(1, 0, 2).reshape(N, s + 1)
    up = torch.as_tensor(up_av, device=dev)[:, None]
    dl = torch.as_tensor(dl_av, device=dev)[:, None]
    ttail = torch.where(up, topw[:, s:s + 1], topw[:, s - 1:s])
    ltail = torch.where(dl, leftw[:, s:s + 1], leftw[:, s - 1:s])
    top = torch.cat([topw[:, :s], ttail.expand(N, 128 - s)], dim=1)
    left = torch.cat([leftw[:, :s], ltail.expand(N, 128 - s)], dim=1)
    tl = Pp[0:HB * s:s, 0:WB * s:s].reshape(N)
    ty, tx = _block_grid(s, W, H)
    row0 = torch.as_tensor(ty == 0, device=dev)
    col0 = torch.as_tensor(tx == 0, device=dev)
    top = torch.where(row0[:, None], 128, top)
    left = torch.where(col0[:, None], 128, left)
    tl = torch.where(row0, left[:, 0], torch.where(~col0, tl, top[:, 0]))
    return top, left, tl


def _blocks(plane, b, HB, WB):
    """[HB*WB, b, b] tiles of the plane's full blocks, raster order."""
    return plane[:HB * b, :WB * b].to(I32).reshape(HB, b, WB, b) \
        .permute(0, 2, 1, 3).reshape(-1, b, b)


def _search_size(orgY, orgU, orgV, s, W, H, fast, nmodes, qpY, qpC, lam,
                 intra_quant=True):
    """Best mode and cost of every full s x s block: ([HB, WB] int32 mode
    map, [HB, WB] int32 cost map), scored by the exact RD measure: the
    Y+U+V reconstruction SSD plus lambda times the exact stream bits
    (write_coeff cost, intra-mode signalling, cbp code). lam is a float32
    0-d tensor: the product lam * bits is taken in float32 and the sum
    truncated, as thor_tpu does. The chroma references use the chroma
    planes' own geometry. intra_quant: the quantizer's offset set."""
    HB, WB = H // s, W // s
    n = HB * WB
    sc = s // 2
    ty, tx = _block_grid(s, W, H)
    up_av = _upright_available_v(ty, tx, s, W)
    dl_av = _downleft_available_v(ty, tx, s, H)
    up_av_c = _upright_available_v(ty // 2, tx // 2, sc, W // 2)
    dl_av_c = _downleft_available_v(ty // 2, tx // 2, sc, H // 2)
    dev = orgY.device
    tyd, txd = torch.as_tensor(ty, device=dev), torch.as_tensor(tx, device=dev)

    def plane_modes(orgs, b, W_, H_, up, dl, ty_, tx_, qp, chroma):
        """All modes of the planes `orgs` (one geometry, one QP) as one
        batch of len(orgs) * nmodes * n blocks: (cbp, ssd, bits), each
        [len(orgs), nmodes, n]."""
        preds, blocks = [], []
        for org in orgs:
            top, left, tl = _block_refs_dev(org, b, W_, H_, up, dl)
            preds += [_predict(left, top, tl, ty_, tx_, b, mode)
                      for mode in range(nmodes)]
            blocks.append(_blocks(org, b, HB, WB).repeat(nmodes, 1, 1))
        pred, blocks = torch.cat(preds), torch.cat(blocks)
        coeff = K.fwd_transform_batch(blocks - pred, b, fast)
        q, cbp = K.quantize_fwd_batch(coeff, qp, b, intra_quant,
                                      zigzag_for(min(b, 16)), chroma)
        rec = K.recon_from_q(pred, q, b, qp)
        ssd = ((blocks - rec) ** 2).sum(dim=(1, 2)).to(I32)
        # exact write_coeff bits of every (plane, mode, block) in one
        # automaton run
        bits = coeff_bits_batch(q, b, True, chroma)
        shape = (len(orgs), nmodes, n)
        return cbp.to(I32).view(shape), ssd.view(shape), bits.view(shape)

    (cy,), (ssd_y,), (bit_y,) = plane_modes(
        [orgY], s, W, H, up_av, dl_av, tyd, txd, qpY, False)
    (cu, cv), (ssd_u, ssd_v), (bit_u, bit_v) = plane_modes(
        [orgU, orgV], sc, W // 2, H // 2, up_av_c, dl_av_c, tyd // 2,
        txd // 2, qpC, True)

    mbits = torch.tensor(_intra_mode_bits(nmodes)[:nmodes], dtype=I32,
                         device=dev)[:, None]
    cbp_bits = torch.tensor(_CBP_BITS, dtype=I32, device=dev)[
        (cy + 2 * cu + 4 * cv).long()]
    bits = (mbits + cbp_bits + torch.where(cy != 0, bit_y, 0)
            + torch.where(cu != 0, bit_u, 0) + torch.where(cv != 0, bit_v, 0))
    cost = (ssd_y + ssd_u + ssd_v) \
        + (lam * bits.to(torch.float32) + 0.5).to(I32)
    best_cost = torch.full((n,), 1 << 30, dtype=I32, device=dev)
    best_mode = torch.zeros((n,), dtype=I32, device=dev)
    for mode in range(nmodes):           # the first mode wins a tie
        better = cost[mode] < best_cost
        best_cost = torch.where(better, cost[mode], best_cost)
        best_mode = torch.where(better, mode, best_mode)
    return best_mode.view(HB, WB), best_cost.view(HB, WB)


def intra_split_decisions(host, W, H):
    """Bottom-up split decisions (host, tiny) over fetched
    {size: (mode_map, cost_map)} numpy maps: ({size: mode_map},
    {size: split_map})."""
    modes = {s: host[s][0] for s in host}
    costs = {s: np.asarray(host[s][1]).astype(np.int64) for s in host}
    split = {}
    agg = costs[8]
    for s in (16, 32, 64):
        HB, WB = H // s, W // s
        child = agg[:HB * 2, :WB * 2].reshape(HB, 2, WB, 2).sum(axis=(1, 3))
        here = costs[s][:HB, :WB]
        split[s] = child < here
        agg = np.where(split[s], child, here)
    return modes, split


def search_intra_frame(org_y, org_u, org_v, qp, qpC, lam, W, H, fast, nmodes,
                       intra_quant=True):
    """The per-size mode searches on the planes' device (lam rounded to
    float32 here), then the bottom-up split decisions on the host:
    ({size: mode_map}, {size: split_map})."""
    lam32 = torch.tensor(lam, dtype=torch.float32, device=org_y.device)
    host = {}
    for s in (8, 16, 32, 64):
        m, c = _search_size(org_y, org_u, org_v, s, W, H, fast, nmodes, qp,
                            qpC, lam32, intra_quant)
        host[s] = (m.cpu().numpy(), c.cpu().numpy())
    return intra_split_decisions(host, W, H)


# ---------------------------------------------------------------------------
# Final pass: exact reconstruction scan
# ---------------------------------------------------------------------------

def _walk_tree(split, modes, W, H):
    """Quadtree walk in decode order -> list of (ty, tx, size, mode). A
    block that is not wholly inside the frame is always split, and no
    leaf is emitted for a part that is not full."""
    out = []

    def rec(s, y, x):
        if y >= H or x >= W:
            return
        full = (y + s <= H) and (x + s <= W)
        if s > 8 and (not full or split[s][y // s, x // s]):
            h = s // 2
            rec(h, y, x)
            rec(h, y + h, x)
            rec(h, y, x + h)
            rec(h, y + h, x + h)
            return
        if full:
            out.append((y, x, s, int(modes[s][y // s, x // s])))

    for k in range(0, H, 64):
        for l in range(0, W, 64):
            rec(64, k, l)
    return out


def scan_records(tus, W, H):
    """(luma, chroma) [N, 7] int32 records of the exact scan from the
    walk's (ty, tx, size, mode) list. The chroma TUs halve the geometry
    but keep the luma TU's availability flags."""
    ty, tx, sz, md = (np.array([t[i] for t in tus], np.int32)
                      for i in range(4))
    up = _upright_available_v(ty, tx, sz, W)
    dl = _downleft_available_v(ty, tx, sz, H)
    luma = {"ty": ty, "tx": tx, "size": sz, "mode": md, "toplen": sz + up,
            "leftlen": sz + dl, "cbx_nonzero": tx > 0}
    chroma = {"ty": ty // 2, "tx": tx // 2, "size": sz // 2, "mode": md,
              "toplen": sz // 2 + up, "leftlen": sz // 2 + dl,
              "cbx_nonzero": tx // 2 > 0}
    return (build_intra_records(luma, H, W),
            build_intra_records(chroma, H // 2, W // 2))


def encode_intra_frame_device(enc, w, org_y, org_u, org_v):
    """Device-searched, device-reconstructed I frame. org_*: the original
    planes as int32 tensors on the encoder's device. Writes the frame's
    block syntax to `w` through the exact host writers and returns the
    unfiltered reconstruction (y, u, v) as int32 tensors on the device.
    Appends the host-clock seconds of search / scan / emit to
    enc.frame_times[-1]; each span ends where the host needs the device's
    results anyway."""
    W, H = enc.width, enc.height
    p = enc.params
    dev = org_y.device
    qpY = enc.frame_qp
    qpC = int(CHROMA_QP[qpY])
    fast = p.encoder_speed > 1
    times = enc.frame_times[-1]

    t0 = time.perf_counter()
    modes, split = search_intra_frame(org_y, org_u, org_v, qpY, qpC,
                                      enc.lambda_, W, H, fast,
                                      enc.num_intra_modes)
    tus = _walk_tree(split, modes, W, H)
    t1 = time.perf_counter()
    times["search"] = t1 - t0

    recs_y, recs_c = scan_records(tus, W, H)
    y, q16y = encode_scan(
        torch.zeros((1, H, W), dtype=I32, device=dev), org_y[None],
        torch.from_numpy(recs_y).to(dev), qpY, fast, True)
    uv, q16c = encode_scan(
        torch.zeros((2, H // 2, W // 2), dtype=I32, device=dev),
        torch.stack([org_u, org_v]), torch.from_numpy(recs_c).to(dev), qpC,
        fast, True)
    q16y = q16y[:, 0].cpu().numpy()
    q16u, q16v = (a for a in q16c.cpu().numpy().transpose(1, 0, 2, 3))
    t2 = time.perf_counter()
    times["scan"] = t2 - t1
    times["tus"] = len(tus)
    # the zero-run pass never clears a level, so "any level nonzero" is
    # the quantizer's cbp
    cbpy, cbpu, cbpv = ((q != 0).any(axis=(1, 2)) for q in (q16y, q16u, q16v))

    # --- host syntax emission through the exact writers ---
    bidx = {(t[0], t[1], t[2]): i for i, t in enumerate(tus)}

    def emit(s, y0, x0):
        if y0 >= H or x0 >= W:
            return
        binfo = BlockInfo(size=s, ypos=y0, xpos=x0,
                          bwidth=min(s, W - x0), bheight=min(s, H - y0),
                          max_num_tb_part=2 if p.enable_tb_split == 1 else 1,
                          max_num_pb_part=1)
        binfo.block_context = find_block_contexts(
            y0, x0, H, W, s, enc.deblock_data, bool(p.use_block_contexts))
        i = bidx.get((y0, x0, s))
        if i is None:
            if s <= 8:
                raise AssertionError("missing leaf")
            if y0 + s <= H and x0 + s <= W:
                write_super_mode(w, enc, binfo, MODE_INTRA, 0, 1)
            if s == 64 and p.max_delta_qp:
                # the decoder reads a delta-QP after every 64-SB super
                # mode on I frames (mode INTRA != SKIP); the device path
                # always codes dqp = 0
                write_delta_qp(w, 0)
            h = s // 2
            emit(h, y0, x0)
            emit(h, y0 + h, x0)
            emit(h, y0, x0 + h)
            emit(h, y0 + h, x0 + h)
            return
        bp = BlockParam(mode=MODE_INTRA, intra_mode=tus[i][3])
        sc = s // 2
        qs, qsc = min(s, 16), min(sc, 16)
        bp.coeff_y = np.zeros((s, s), np.int16)
        bp.coeff_u = np.zeros((sc, sc), np.int16)
        bp.coeff_v = np.zeros((sc, sc), np.int16)
        bp.coeff_y[:qs, :qs] = q16y[i][:qs, :qs]
        bp.coeff_u[:qsc, :qsc] = q16u[i][:qsc, :qsc]
        bp.coeff_v[:qsc, :qsc] = q16v[i][:qsc, :qsc]
        bp.cbp = (int(cbpy[i]), int(cbpu[i]), int(cbpv[i]))
        bp.tb_param = 0
        write_block(w, enc, binfo, bp)
        binfo.block_param = bp
        enc.store_deblock_data(binfo)

    for k in range(0, H, 64):
        for l in range(0, W, 64):
            emit(64, k, l)
    times["emit"] = time.perf_counter() - t2
    return y[0], uv[0], uv[1]
