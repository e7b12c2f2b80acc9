"""The device encoder's P/B frame as CUDA graphs, one per signature.

Counterpart of thor_tpu's fused dispatch of the device encoder
(thor_tpu/enc/device_inter.py: _measure_all_fn :348, _extra_trial_fn
:1534, _final_all :702 with _dispatch_final_fused :752 and _filter_fn
:598, the selection at :1946-1977, _finish_frame_fused :2238 and the
replay's at :2336-2347). thor_tpu jits each half of a frame as one
program; on the card the counterpart of one jitted program is one CUDA
graph. A P/B frame runs three:

  - measure: ME (enc/device_me), the motion variants and the trials of
    the four block sizes, then the intra search with the inter quantizer
    (enc/device_intra), the host's cost maps packed into one buffer;
  - extra: the second chance's [K_EXTRA, N] variants of all four sizes;
  - final: the decoder's block MC (kernel 2) over the decided PUs, their
    records padded to a bucket with the real count on the card; the
    residual of the chosen trial banks in thor_tpu's dense per-size
    layout (a variant index and a coded mask per block of every size,
    _final_mc_fn.dense_add :427, so the shapes follow the frame's
    geometry); the intra scan (kernel 6, bucketed with a count, 0 when
    the frame has no intra leaf) over the intra leaves; the CLPF-mask
    patch from the scans' levels; deblocking on the side-info map the
    walk's leaves replay into; the CLPF decision and filter; the uint8
    planes and the padded reference planes; the chosen levels of every
    block of every size, in the same dense layout (the emit reads the
    coded leaves' rows); and one buffer of what the host fetches.

The host's decision walk and second chance, and the emit, stay on the
host (enc/device_inter). Per P/B frame the host waits three times: for
the measure maps, for the second chance's maps (when there is one) and
for the final fetch (planes, CLPF bits, intra levels, chosen
coefficients).

Entries. One entry per measure signature (the geometry, the reference
count, the bipred slots, the filter set, tb split, speed, the intra mode
count and the two QPs: the ops read them as Python numbers) and lane
(ops/graphs: the device and the current stream, so each clone of the
sharded encoder replays on its own slot) lives in ops/graphs' CACHE
beside the decoder's frame entries, the interpolated reference's entries
(ops/interp_fused.py; an RA form's B frame replays one before its
measure program) and the I frame's (enc/fused_intra.py, which reuses this
module's fetch, buckets, final runner and filter tail), sharing the
lane's graph pool and side stream. It holds the input buffers (the
original planes, the reference stacks, one packed buffer of the signs and
lambdas), the measure program, the extra program and up to FINALS final
programs by their own signature (the filters, whether the second chance
ran, and the layout of the final's packed inputs, which names the MC and
intra buckets; an entry's buckets only grow, _bucket, so a sequence
captures a new final only when a frame needs more records than any
before it or a second chance for the first time). Every program reads
its inputs from the entry's buffers and its predecessors' outputs in
place; every output lives until the same program runs again. So a frame
holds the lane's lock from its measure's load to its final's fetch
(measure_frame takes it, finish_frame or release gives it back): no other
program of the lane replays in between, which would reuse the graph
pool's memory under the trial banks that the final reads, and no other
frame measures on the entry (the sharded encoder gives a slot one frame
in flight at a time). Inputs cross from the host in one pinned buffer
per program, copied on the stream without a wait.

On the CPU the same entries run their programs without a graph, through
the kernels' plain versions. A capture that fails raises; nothing falls
back to the eager path (enc/device_inter's stage-wise functions, which
Encoder(fused=False) and ShardedEncoder(fused=False) run).
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from ..codec.constants import (
    BETA_TABLE, CHROMA_QP, GDEQUANT_TABLE, MAX_BLOCK_SIZE, MODE_INTRA, PAD_C,
    PAD_Y, TC_TABLE)
from ..dec import fused as DF
from ..dec.reconstruct import mc_luts
from ..ops import graphs as G, kernels as K
from ..ops.enc_intra import encode_scan
from ..ops.intra import NF as INTRA_NF
from ..ops.mc import NF as MC_NF, mc_frame
from ..utils.tracing import count_wait, span
from . import device_inter as DI
from .device_intra import scan_records, search_intra_frame_dev
from .device_me import me_frame

FINALS = 64                 # final programs an entry keeps
I32 = torch.int32


class MeasureSig(NamedTuple):
    """What a frame's measure program depends on besides the device."""
    H: int
    W: int
    R: int
    has_bi: bool
    bslot0: int
    bslot1: int
    seq_bipred: int
    tb_split: int
    speed: int
    nmodes: int
    qpY: int
    qpC: int


class FinalSig(NamedTuple):
    deblocking: bool
    clpf: bool
    extra: bool
    layout: tuple


def _sizes(sig):
    return [(s, sig.H // s, sig.W // s) for s in DI.SIZES]


def _flags(sig, s):
    return DI.trial_flags(sig.speed, sig.tb_split, s)


def _as_bytes(named):
    """[(key, tensor)] -> (one flat uint8 tensor of their bytes, the
    layout [(key, dtype, shape)] that host_maps reads it back with). The
    widest types go first, so every array's offset is a multiple of its
    item size (the C walk reads the maps in place)."""
    named = sorted(named, key=lambda kt: -kt[1].element_size())
    flat = torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                      for _, t in named])
    return flat, [(k, str(t.dtype).split(".")[1], tuple(t.shape))
                  for k, t in named]


_NP = {"uint8": np.uint8, "bool": np.bool_, "int16": np.int16,
       "int32": np.int32, "int64": np.int64}


def host_maps(raw, layout):
    """The arrays of a fetched flat buffer: {key: numpy array}."""
    out, pos = {}, 0
    for k, dt, shape in layout:
        dtype = np.dtype(_NP[dt])
        n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        out[k] = raw[pos:pos + n].view(dtype).reshape(shape)
        pos += n
    return out


def fetch(flat):
    """The host's copy of a device buffer: one wait (through a pinned
    buffer on a card), counted on the CPU too."""
    count_wait()
    if flat.device.type != "cuda":
        return flat.numpy()
    host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
    host.copy_(flat, non_blocking=True)
    torch.cuda.current_stream(flat.device).synchronize()
    return host.numpy()


def _bucket(e, key, a, fill, width):
    """Records padded to the entry's bucket for `key` and their count. The
    bucket is dec/fused's (powers of 4 from 16) but never shrinks: a frame
    with fewer records than an earlier frame of the entry takes the
    earlier, larger bucket, and so its final program."""
    a = np.asarray(a, np.int32).reshape(-1, width)
    cap = e.caps[key] = max(DF.pow4_bucket(len(a)), e.caps.get(key, 0))
    return DF._pad(a, cap, fill), np.array([len(a)], np.int32)


def pick_rows(main, extra, K_uni, k, idx):
    """Rows (k, idx) of a trial bank in the second chance's [uni | extra |
    bi] variant order, without splicing: main [K, N, ...] the measure's
    bank, extra [K_EXTRA, N, ...] the extra trials' or None."""
    if extra is None:
        return main[k, idx]
    sel = (k >= K_uni) & (k < K_uni + DI.K_EXTRA)
    km = torch.clamp(torch.where(k >= K_uni + DI.K_EXTRA, k - DI.K_EXTRA,
                                 k), max=main.shape[0] - 1)
    ke = torch.clamp(k - K_uni, 0, DI.K_EXTRA - 1)
    a, b = main[km, idx], extra[ke, idx]
    return torch.where(sel.view(-1, *([1] * (a.dim() - 1))), b, a)


# ---------------------------------------------------------------------------
# Programs
# ---------------------------------------------------------------------------

def small_fields(lam, lam_me, sign, sign_bi):
    """The measure program's per-frame numbers, as pack_fields takes them:
    lam (the intra search's) and lam_me (ME's) float32, the [R] MV signs
    of uni-prediction and bipred."""
    return {"lam": np.array(lam, np.float32),
            "lam_me": np.array(lam_me, np.float32),
            "sign": np.asarray(sign, np.int32),
            "sign_bi": np.asarray(sign_bi, np.int32)}


def ev_fields(ev):
    """The extra program's inputs, as pack_fields takes them: ev {size:
    (mvy, mvx, slot) [K_EXTRA, N] int32} (device_inter.extra_variants)."""
    return {f"e{s}": {"y": np.asarray(ev[s][0], np.int32),
                      "x": np.asarray(ev[s][1], np.int32),
                      "s": np.asarray(ev[s][2], np.int32)}
            for s in DI.SIZES}


def measure_program(e):
    """ME, the motion variants, the trials of every size and the intra
    search on the entry's buffers: (variants, trials, flat, layout), flat
    holding the host's maps (the variants, the trials' cost maps and the
    intra search's mode and cost maps)."""
    sig, (oy, ou, ov), refs, sv = e.sig, e.org, e.refs, e.small_in
    H, W, R = sig.H, sig.W, sig.R
    org = (oy, ou, ov)
    me = me_frame(oy, refs[0], sv["lam_me"], sig.seq_bipred)
    variants = DI.motion_variants(me, H, W, R, sig.has_bi, sig.bslot0,
                                  sig.bslot1, sv["sign"], sv["sign_bi"])
    luts = (K.build_luma_mc_lut(sig.seq_bipred), K.build_chroma_mc_lut())
    trials = {s: DI.trial_coding(org, refs, variants[s], s, sig.qpY,
                                 sig.qpC, sv["sign"], sv["sign_bi"],
                                 luts=luts, k_bi=3 + R, **_flags(sig, s))
              for s in DI.SIZES}
    intra = search_intra_frame_dev(oy, ou, ov, sig.qpY, sig.qpC, sv["lam"],
                                   W, H, sig.speed > 1, sig.nmodes,
                                   intra_quant=False)
    named = []
    for s in DI.SIZES:
        named += [(("var", s, k), variants[s][k]) for k in DI.VAR_KEYS]
        named += [(("meas", s, k), trials[s][k]) for k in DI.MEAS_KEYS
                  if k in trials[s]]
        named += [(("intra", s, j), intra[s][j]) for j in (0, 1)]
    flat, layout = _as_bytes(named)
    return variants, trials, flat, layout


def extra_program(e):
    """The second chance's trials of every size on the entry's buffers:
    (trials, flat, layout)."""
    sig, org, refs, sv = e.sig, e.org, e.refs, e.small_in
    luts = (K.build_luma_mc_lut(sig.seq_bipred), K.build_chroma_mc_lut())
    trials, named = {}, []
    for s in DI.SIZES:
        ev = e.ev_in[f"e{s}"]
        z = torch.zeros_like(ev["y"])
        var = {"mvy": ev["y"], "mvx": ev["x"], "slot": ev["s"], "mvy1": z,
               "mvx1": z, "slot1": z, "bi": z}
        trials[s] = DI.trial_coding(org, refs, var, s, sig.qpY, sig.qpC,
                                    sv["sign"], sv["sign_bi"], luts=luts,
                                    k_bi=DI.K_EXTRA, **_flags(sig, s))
        named += [(("meas", s, k), trials[s][k]) for k in DI.MEAS_KEYS
                  if k in trials[s]]
    flat, layout = _as_bytes(named)
    return trials, flat, layout


def _dense_add(r, q, cb, s, sy, fac):
    """Add the residual of [N, sy, sy] level blocks (masked by cb) at the
    raster grid of s x s blocks of plane r (_final_mc_fn.dense_add)."""
    HH, WW = r.shape
    HB, WB = HH // s, WW // s
    N = HB * WB
    sh = int(math.log2(s)) - 1
    dev = r.device
    q = torch.where(cb[:, None, None], q.to(I32), 0)
    vals = K.residual_group(
        q, torch.full((N,), fac, dtype=I32, device=dev),
        torch.full((N,), 1 << (sh - 1), dtype=I32, device=dev),
        torch.full((N,), sh, dtype=I32, device=dev), sy)
    if sy != s:
        vals = vals.repeat_interleave(2, 1).repeat_interleave(2, 2)
    r = r.clone()
    r[:HB * s, :WB * s] += vals.reshape(HB, WB, s, s).permute(0, 2, 1, 3) \
        .reshape(HB * s, WB * s)
    return r


def _quad_rows(HB, WB, WW, b2):
    """Half-size-grid row of each (block, k) quadrant (_final_mc_fn
    .quad_rows): the s-grid does not cover the b2-grid at an edge that is
    not a multiple of s."""
    WB2 = -(-WW // b2)
    by, bx = np.meshgrid(np.arange(HB), np.arange(WB), indexing="ij")
    qi, qj = np.meshgrid(np.arange(2), np.arange(2), indexing="ij")
    rows = ((by[:, :, None, None] * 2 + qi) * WB2
            + bx[:, :, None, None] * 2 + qj)
    return rows.reshape(-1).astype(np.int64)


def _dense_add_quads(r, q, mask, tb_on, HB, WB, b2, fac):
    """The tb-split residual: [N, 2 b2, 2 b2] quadrant-layout levels, the
    [N] 4-bit cbp masks (quadrant k at bit 3 - k) gated by tb_on, added at
    the quadrants' rows of the b2 grid (_final_mc_fn.dense_add_at)."""
    HH, WW = r.shape
    dev = r.device
    HB2, WB2 = -(-HH // b2), -(-WW // b2)
    bit = K.const(np.array([3, 2, 1, 0], np.int32), dev)
    cb = ((((mask[:, None] >> bit) & 1) != 0) & tb_on[:, None]).reshape(-1)
    qq = DI._quads(q, b2)
    M = qq.shape[0]
    sh = int(math.log2(b2)) - 1
    qq = torch.where(cb[:, None, None], qq.to(I32), 0)
    vals = K.residual_group(
        qq, torch.full((M,), fac, dtype=I32, device=dev),
        torch.full((M,), 1 << (sh - 1), dtype=I32, device=dev),
        torch.full((M,), sh, dtype=I32, device=dev), b2)
    bank = torch.zeros((HB2 * WB2, b2 * b2), dtype=I32, device=dev)
    bank.index_add_(0, K.const(_quad_rows(HB, WB, WW, b2), dev),
                    vals.reshape(M, -1))
    return r + bank.view(HB2, WB2, b2, b2).permute(0, 2, 1, 3) \
        .reshape(HB2 * b2, WB2 * b2)[:HH, :WW]


def filter_tail(y, u, v, org_y, ddp, cm, qp, H, W, deblocking, clpf):
    """The final program's filters (thor_tpu's _filter_fn :598): deblocking
    on the packed side-info map ddp, the CLPF decision (the encoder's SSD
    rule per superblock, over the candidate masks cm [3, H/8, W/8]) and
    the filter on the superblocks it switches on, then the uint8 planes
    and the padded reference planes. Returns (y, u, v uint8, bit_sb
    [max(SBH, 1), max(SBW, 1)] bool, (Y, U, V) padded)."""
    if deblocking:
        dd = K.unpack_ddp(ddp)
        tc_c = int(TC_TABLE[CHROMA_QP[qp]])
        y = K.deblock_luma(y, dd, H, W, int(BETA_TABLE[qp]),
                           int(TC_TABLE[qp]))
        u = K.deblock_chroma(u, dd, H, W, tc_c)
        v = K.deblock_chroma(v, dd, H, W, tc_c)
    SBH, SBW = H // MAX_BLOCK_SIZE, W // MAX_BLOCK_SIZE
    bit_sb = torch.zeros((max(SBH, 1), max(SBW, 1)), dtype=torch.bool,
                         device=y.device)
    if clpf and SBH and SBW:
        sums = DI.clpf_sb_sums(y, org_y, cm[0], H, W)
        bit_sb = sums[1] < sums[0]
        cand = (cm[0] | cm[1] | cm[2])[:SBH * 8, :SBW * 8] \
            .reshape(SBH, 8, SBW, 8).any(dim=3).any(dim=1)
        on8 = torch.zeros_like(cm[0])
        on8[:SBH * 8, :SBW * 8] = (cand & bit_sb).repeat_interleave(8, 0) \
            .repeat_interleave(8, 1)
        y, u, v = DI.clpf_apply(y, u, v, cm, on8, H, W)
    y, u, v = (t.to(torch.uint8) for t in (y, u, v))
    return y, u, v, bit_sb, (K.edge_pad(y, PAD_Y), K.edge_pad(u, PAD_C),
                             K.edge_pad(v, PAD_C))


def final_program(e, f):
    """The final reconstruction and the filters of one frame on the
    entry's buffers and f's inputs: (y, u, v uint8, (Y, U, V) padded,
    flat, layout), flat holding what the host fetches."""
    sig, inp = e.sig, f.inp
    H, W, R = sig.H, sig.W, sig.R
    dev = e.org[0].device
    oy, ou, ov = e.org
    trials = e.measure.out[1]
    extra = e.extra.out[0] if f.sig.extra else None
    K_uni = 3 + R
    luts = mc_luts(sig.seq_bipred, dev)
    py = mc_frame(e.ry[None], inp["mc_y"], luts[0], H, W,
                  count=inp["mc_y_n"])[0]
    puv = mc_frame(e.rc, inp["mc_c"], luts[1], H // 2, W // 2,
                   count=inp["mc_c_n"])
    qpY, qpC = sig.qpY, sig.qpC
    facY = int(GDEQUANT_TABLE[qpY % 6]) << (qpY // 6)
    facC = int(GDEQUANT_TABLE[qpC % 6]) << (qpC // 6)
    rs = [torch.zeros((H, W), dtype=I32, device=dev),
          torch.zeros((H // 2, W // 2), dtype=I32, device=dev),
          torch.zeros((H // 2, W // 2), dtype=I32, device=dev)]
    coeffs = []
    for s, HB, WB in _sizes(sig):
        t, t2 = trials[s], None if extra is None else extra[s]
        ks, m = inp[f"k{s}"]["k"].long(), inp[f"k{s}"]["m"]
        ar = torch.arange(HB * WB, device=dev)

        def pick(key, k=ks, idx=ar):
            return pick_rows(t[key], None if t2 is None else t2[key], K_uni,
                             k, idx)

        tb, t_on = _flags(sig, s)["tb"], inp[f"k{s}"]["t"]
        for j, c in enumerate("yuv"):
            b, fac = (s, facY) if c == "y" else (s // 2, facC)
            q = pick(f"q{c}")
            rs[j] = _dense_add(rs[j], q[:, :32, :32] if b == 64 else q,
                               pick(f"cbp_{c}") & m, b, min(b, 32), fac)
            if tb:
                qt = pick(f"q{c}_tb")
                rs[j] = _dense_add_quads(rs[j], qt, pick(f"cbp_tb_{c}"),
                                         t_on, HB, WB, b // 2, fac)
                q = torch.where(t_on[:, None, None], qt, q)
            # the chosen levels of every block, row = block index: the
            # emit reads the coded leaves' rows
            coeffs.append((("coef", s, f"q{c}"), q))
    y, u, v = (K.clip255(py + rs[0]), K.clip255(puv[0] + rs[1]),
               K.clip255(puv[1] + rs[2]))
    cm = inp["cm"] if "cm" in inp else torch.zeros(
        (3, H // 8, W // 8), dtype=torch.bool, device=dev)
    yy, q16y = encode_scan(y[None].contiguous(), oy[None], inp["it_y"],
                           qpY, sig.speed > 1, False, count=inp["it_n"])
    uv, q16c = encode_scan(torch.stack([u, v]), torch.stack([ou, ov]),
                           inp["it_c"], qpC, sig.speed > 1, False,
                           count=inp["it_n"])
    y, u, v = yy[0], uv[0], uv[1]
    named = [(("q16y",), q16y), (("q16c",), q16c)]
    if "cm" in inp:
        # the walk's map prices intra cbp as (1, 1, 1): the cells of the
        # intra TUs take the cbp their levels give (_final_all :727-744);
        # deblocking reads intra edges by mode alone
        bits = sum((q != 0).any(dim=(1, 2)).to(I32) << j for j, q in
                   enumerate((q16y[:, 0], q16c[:, 0], q16c[:, 1])))
        ow = inp["own8"]
        got = bits[torch.clamp(ow - 1, 0, bits.shape[0] - 1).long()]
        cm = torch.stack([torch.where(ow > 0, (got & (1 << j)) != 0, cm[j])
                          for j in range(3)])
    y, u, v, bit_sb, padded = filter_tail(
        y, u, v, oy, inp.get("ddp"), cm, qpY, H, W, f.sig.deblocking,
        f.sig.clpf)
    flat, layout = _as_bytes([(("y",), y), (("u",), u), (("v",), v),
                              (("bit_sb",), bit_sb), (("cm",), cm)]
                             + named + coeffs)
    return y, u, v, padded, flat, layout


# ---------------------------------------------------------------------------
# Entries
# ---------------------------------------------------------------------------

class _Final(G.GraphProgram):
    """One final signature's packed input buffer and program."""

    def __init__(self, fsig: FinalSig, dev):
        super().__init__()
        self.sig = fsig
        _, total = DF._offsets(fsig.layout)
        self.flat = torch.empty(total, dtype=torch.uint8, device=dev)
        self.inp = DF.unpack(self.flat, fsig.layout)


class EncEntry:
    """One measure signature's input buffers and programs on one lane
    (see the module notes)."""

    def __init__(self, sig: MeasureSig, ln):
        H, W, R = sig.H, sig.W, sig.R
        self.sig, self.lane, self.dev = sig, ln, ln.dev
        dev = ln.dev
        u8 = dict(dtype=torch.uint8, device=dev)
        self.oy = torch.empty((H, W), dtype=I32, device=dev)
        self.oc = torch.empty((2, H // 2, W // 2), dtype=I32, device=dev)
        self.org = (self.oy, self.oc[0], self.oc[1])
        self.ry = torch.empty((R, H + 2 * PAD_Y, W + 2 * PAD_Y), **u8)
        self.rc = torch.empty((2, R, H // 2 + 2 * PAD_C, W // 2 + 2 * PAD_C),
                              **u8)
        self.refs = (self.ry, self.rc[0], self.rc[1])
        lay, _ = DF.pack_fields(small_fields(0.0, 0.0, [0] * R, [0] * R))
        self.small = torch.empty(DF._offsets(lay)[1], **u8)
        self.small_in = DF.unpack(self.small, lay)
        z = {s: (np.zeros((DI.K_EXTRA, hb * wb), np.int32),) * 3
             for s, hb, wb in _sizes(sig)}
        lay, _ = DF.pack_fields(ev_fields(z))
        self.ev = torch.empty(DF._offsets(lay)[1], **u8)
        self.ev_in = DF.unpack(self.ev, lay)
        self.measure = G.GraphProgram()
        self.extra = G.GraphProgram()
        self.finals: OrderedDict = OrderedDict()
        self.caps: dict = {}        # final input -> its bucket (_bucket)

    @property
    def graph(self):
        """A graph of the entry, if it holds one (ops/graphs.FrameCache)."""
        return self.measure.graph

    def input_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (
            self.oy, self.oc, self.ry, self.rc, self.small, self.ev)) \
            + sum(f.flat.numel() for f in self.finals.values())

    def run_measure(self, org, refs, small):
        """Load a frame's original planes (y, u, v), its reference objects
        (.y / .u / .v padded uint8 on the device, slot order) and its
        packed signs and lambdas, then run the measure program."""
        self.oy.copy_(org[0])
        self.oc[0].copy_(org[1])
        self.oc[1].copy_(org[2])
        torch.stack([r.y for r in refs], out=self.ry)
        torch.stack([r.u for r in refs], out=self.rc[0])
        torch.stack([r.v for r in refs], out=self.rc[1])
        self.small.copy_(small, non_blocking=True)
        return self.measure.run(self.lane, lambda: measure_program(self))

    def run_extra(self, ev):
        """Load the second chance's packed variants and run the extra
        program (after run_measure of the same frame)."""
        self.ev.copy_(ev, non_blocking=True)
        return self.extra.run(self.lane, lambda: extra_program(self))

    def run_final(self, fsig: FinalSig, buf):
        """Load a frame's packed final inputs and run the final program
        of their signature (after run_measure and, with fsig.extra,
        run_extra of the same frame)."""
        return run_final_of(self, fsig, buf, final_program)


def run_final_of(e, fsig, buf, program):
    """Load packed final inputs `buf` into entry e's final program of
    signature fsig (made at its first use, at most FINALS kept, the least
    recently used going first) and run program(e, final) there, on e's
    lane. A final whose first run fails leaves the entry again."""
    f = e.finals.get(fsig)
    fresh = f is None
    if fresh:
        f = e.finals[fsig] = _Final(fsig, e.dev)
        while len(e.finals) > FINALS:
            _, old = e.finals.popitem(last=False)
            if old.graph is not None:
                e.lane.drain()
            G.STATS["evictions"] += 1
    else:
        e.finals.move_to_end(fsig)
    try:
        f.flat.copy_(buf, non_blocking=True)
        return f.run(e.lane, lambda: program(e, f))
    except BaseException:
        if fresh:
            e.finals.pop(fsig, None)
        raise


def run_measure(dev, sig, org, refs, small):
    """EncEntry.run_measure on the cache's entry of sig on the lane of
    `dev` (its current stream), made at its first use: (entry, the
    measure outputs). A new entry whose first run fails leaves the cache
    again. The caller holds the lane's lock (G.lane(dev).lock) through
    the frame's final."""
    ln = G.lane(dev)
    key = (ln, ("enc", sig))
    e, fresh = G.CACHE.get(key, lambda: EncEntry(sig, ln))
    try:
        return e, e.run_measure(org, refs, small)
    except BaseException:
        if fresh:
            G.CACHE.discard(key)
        raise


# ---------------------------------------------------------------------------
# The frame driver (enc/device_inter's measure / finish, fused)
# ---------------------------------------------------------------------------

def measure_frame(enc, org, refs, sign, sign_bi, has_bi, bslot0, bslot1,
                  qpY, qpC, lam, lam_me):
    """The measure half of a P/B frame on the fused path: one program,
    one fetch. Returns the context finish_frame drains. Spans: enc.measure
    (frame_times "measure"), of it enc.measure.pack, .program (the
    graph's replay or capture) and .fetch."""
    p = enc.params
    dev = org[0].device
    with span("enc.measure", enc.frame_times[-1], "measure"):
        c0, ms0 = G.STATS["captures"], G.STATS["capture_ms"]
        sig = MeasureSig(enc.height, enc.width, enc.num_ref, has_bi, bslot0,
                         bslot1, int(p.enable_bipred),
                         int(p.enable_tb_split), int(p.encoder_speed),
                         int(enc.num_intra_modes), qpY, qpC)
        with span("enc.measure.pack"):
            _, small = DF.pack_fields(small_fields(lam, lam_me, sign,
                                                   sign_bi),
                                      pin=dev.type == "cuda")
        lock = G.lane(dev).lock
        lock.acquire()              # until the final's fetch (release)
        try:
            with span("enc.measure.program"):
                e, (_, _, flat, layout) = run_measure(dev, sig, org, refs,
                                                      small)
            with span("enc.measure.fetch"):
                got = host_maps(fetch(flat), layout)
        except BaseException:
            lock.release()
            raise
        meas = {}
        for s in DI.SIZES:
            meas[s] = {k: got[("var", s, k)] for k in DI.VAR_KEYS}
            meas[s].update({k: got[("meas", s, k)] for k in DI.MEAS_KEYS
                            if ("meas", s, k) in got})
            meas[s]["K_uni"] = 3 + enc.num_ref
        intra = {s: (got[("intra", s, 0)], got[("intra", s, 1)])
                 for s in DI.SIZES}
    return dict(fused=True, entry=e, lock=lock, sig=sig, small=small,
                meas=meas, intra=intra, org=org, sign_np=sign,
                sign_bi_np=sign_bi, lam=lam, lam_me=lam_me, qpY=qpY,
                qpC=qpC, extra=None, captures0=c0, capture_ms0=ms0)


def release(ctx):
    """Give back the lane's lock that the frame of `ctx` took at its
    measure (once; later calls do nothing)."""
    lock = ctx.pop("lock", None)
    if lock is not None:
        lock.release()


def second_chance(enc, ctx, leaves):
    """The second chance on the fused path: the extra program over the
    first walk's unmatched skip candidates, its maps fetched in one wait
    and spliced into the host maps in [uni | extra | bi] order. Returns
    False when nothing was missing. Spans: enc.second_chance.collect (the
    missing candidates, their variants, the pack), .program, .fetch and
    .splice."""
    W, H = enc.width, enc.height
    meas = ctx["meas"]
    dev = ctx["org"][0].device
    with span("enc.second_chance.collect"):
        missing = DI.collect_missing(W, H, leaves, meas)
        if not any(missing[s] for s in DI.SIZES):
            return False
        ev = DI.extra_variants(missing, H, W)
        _, buf = DF.pack_fields(ev_fields(ev), pin=dev.type == "cuda")
    with span("enc.second_chance.program"):
        _, flat, layout = ctx["entry"].run_extra(buf)
    with span("enc.second_chance.fetch"):
        got = host_maps(fetch(flat), layout)
    with span("enc.second_chance.splice"):
        for s in DI.SIZES:
            m = meas[s]
            K_uni = m["K_uni"]
            ey, ex, es = ev[s]
            z = np.zeros_like(ey)
            for k, a in zip(DI.VAR_KEYS, (ey, ex, es, z, z, z, z)):
                m[k] = DI._insert(m[k], a, K_uni)
            for k in DI.MEAS_KEYS:
                if ("meas", s, k) in got:
                    m[k] = DI._insert(m[k], got[("meas", s, k)], K_uni)
            m["K_uni"] = K_uni + DI.K_EXTRA
    ctx["extra"] = buf
    return True


def final_inputs(enc, ctx, leaves):
    """The final program's packed inputs from the decided leaves (numpy):
    the MC records (bucketed, with counts), the dense per-size variant
    index / coded / tb-split maps, the intra scan records (bucketed, with
    their count; none is a count of 0) and the 8x8 cells each intra TU
    owns, and the side-info map and CLPF candidate masks of the walk's
    leaves replayed into enc.deblock_data (store_leaf_dd, as thor_tpu
    does at :1955-1964). Returns (dict, PU count, intra leaves, coded
    leaves by size)."""
    W, H = enc.width, enc.height
    p = enc.params
    e, meas = ctx["entry"], ctx["meas"]
    recs_y, recs_c, npu = DI.mc_records(leaves, ctx["sign_np"],
                                        ctx["sign_bi_np"], H, W)
    inp = {}
    inp["mc_y"], inp["mc_y_n"] = _bucket(e, "mc", recs_y, 0, MC_NF)
    inp["mc_c"], inp["mc_c_n"] = _bucket(e, "mc", recs_c, 0, MC_NF)
    coded = {s: [lf for lf in leaves if lf.mode != MODE_INTRA and lf.use_cbp
                 and lf.size == s] for s in DI.SIZES}
    for s in DI.SIZES:
        N = (H // s) * (W // s)
        k, m, t = (np.zeros(N, np.int32), np.zeros(N, bool),
                   np.zeros(N, bool))
        for lf in coded[s]:
            k[lf.idx] = lf.k
            (t if lf.tb else m)[lf.idx] = True
        inp[f"k{s}"] = {"k": k, "m": m, "t": t}
    intra = [lf for lf in leaves if lf.mode == MODE_INTRA]
    SBH, SBW = H // MAX_BLOCK_SIZE, W // MAX_BLOCK_SIZE
    ry = rc = np.zeros((0, INTRA_NF), np.int32)
    if intra:
        ry, rc = scan_records([(lf.ypos, lf.xpos, lf.size, lf.intra_mode)
                               for lf in intra], W, H)
    inp["it_y"], inp["it_n"] = _bucket(e, "it", ry, DF.INTRA_PAD, INTRA_NF)
    inp["it_c"], _ = _bucket(e, "it", rc, DF.INTRA_PAD, INTRA_NF)
    own8 = np.zeros((H // 8, W // 8), np.int32)
    for i, lf in enumerate(intra):
        own8[lf.ypos // 8:(lf.ypos + lf.size) // 8,
             lf.xpos // 8:(lf.xpos + lf.size) // 8] = i + 1
    own8[SBH * 8:] = 0          # the candidates live in whole SBs
    own8[:, SBW * 8:] = 0
    inp["own8"] = own8
    dd = enc.deblock_data
    dd.reset()
    for lf in leaves:
        DI.store_leaf_dd(dd, lf, meas[lf.size])
    if p.deblocking:
        inp["ddp"] = K.pack_ddp({k: getattr(dd, k) for k in (
            "size", "tb_split", "pb_part", "mode", "cbp_y", "mv0x", "mv0y",
            "mv1x", "mv1y")})
    if p.clpf and SBH and SBW:
        inp["cm"] = np.stack(DI.clpf_cand_masks(dd, H, W))
    return inp, npu, intra, coded


def finish_frame(enc, w, ctx, leaves):
    """The final program of a decided frame and its one fetch, then the
    emit through the C writers (which rewrite enc.deblock_data). Returns
    {"planes": (y, u, v) uint8 on the device, "padded": the reference's
    planes, "host": the planes fetched, "bit_sb": the CLPF decision per
    superblock, "cm": the CLPF candidate masks the program patched and
    used, "ddp": the walk's side-info map it deblocked on}. Records
    "final" (of it "final_inputs", the host's share up to the packed
    inputs) and "emit" in enc.frame_times[-1], with "pus",
    "intra_leaves", and the graphs the frame captured, "captures" (its
    three programs; "capture", their host seconds, inside the stages'
    times) and "final_captures" (the final one). Spans: enc.final, of it
    enc.final_inputs, enc.final.program and enc.final.fetch; enc.emit."""
    p = enc.params
    times = enc.frame_times[-1]
    dev = ctx["org"][0].device
    with span("enc.final", times, "final"):
        with span("enc.final_inputs", times, "final_inputs"):
            inp, npu, intra, coded = final_inputs(enc, ctx, leaves)
            layout, buf = DF.pack_fields(inp, pin=dev.type == "cuda")
        fsig = FinalSig(bool(p.deblocking), bool(p.clpf),
                        ctx["extra"] is not None, layout)
        c0 = G.STATS["captures"]
        try:
            with span("enc.final.program"):
                y, u, v, padded, flat, flayout = ctx["entry"].run_final(
                    fsig, buf)
                planes = tuple(t.clone() for t in (y, u, v))
                padded = tuple(t.clone() for t in padded)
            with span("enc.final.fetch"):
                got = host_maps(fetch(flat), flayout)
        finally:
            release(ctx)
        times["final_captures"] = G.STATS["captures"] - c0
        times["captures"] = G.STATS["captures"] - ctx["captures0"]
        times["capture"] = (G.STATS["capture_ms"]
                            - ctx["capture_ms0"]) / 1e3
        ctx.update(fsig=fsig, fbuf=buf)
        intra_q = {}
        if intra:
            n = len(intra)
            q16c = got[("q16c",)]
            intra_q = {"qy": got[("q16y",)][:n, 0], "qu": q16c[:n, 0],
                       "qv": q16c[:n, 1]}
            # the zero-run pass never clears a level, so "any level
            # nonzero" is the quantizer's cbp
            for c in "yuv":
                intra_q["c" + c] = (intra_q["q" + c] != 0).any(axis=(1, 2))
            intra_q["index"] = {(lf.ypos, lf.xpos): i
                                for i, lf in enumerate(intra)}
        coeff_host = {}
        for s in DI.SIZES:
            if coded[s]:
                coeff_host[s] = {c: got[("coef", s, c)]
                                 for c in ("qy", "qu", "qv")}
                coeff_host[s]["index"] = {(lf.ypos, lf.xpos): lf.idx
                                          for lf in coded[s]}
    times["pus"] = npu
    times["intra_leaves"] = len(intra)
    with span("enc.emit", times, "emit"):
        enc.deblock_data.reset()
        DI.emit_frame(enc, w, leaves, ctx["meas"], coeff_host, intra_q)
    return {"planes": planes, "padded": padded, "bit_sb": got[("bit_sb",)],
            # copied out of the pinned fetch buffer: a sequence's
            # reconstructions outlive it
            "host": tuple(got[(c,)].copy() for c in "yuv"),
            "cm": got[("cm",)],
            "ddp": inp.get("ddp")}


def replay_frame(rec, refstate):
    """Run one recorded P/B frame's programs again (the measure, the
    extra trials when the frame had a second chance, the final with its
    filters) against the reference chain in `refstate` ({key: padded
    (Y, U, V)}), from the record's packed inputs. Inserts the frame's
    padded reference planes into refstate and returns its (y, u, v) uint8
    reconstruction. No host wait."""
    for key, planes in rec["uploads"].items():
        refstate.setdefault(key, planes)

    class _Ref:
        def __init__(self, planes):
            self.y, self.u, self.v = planes

    refs = [_Ref(refstate[k]) for k in rec["ref_keys"]]
    f = rec["fused"]
    org = rec["org"]
    with G.lane(org[0].device).lock:
        e, _ = run_measure(org[0].device, f["sig"], org, refs, f["small"])
        if f["extra"] is not None:
            e.run_extra(f["extra"])
        y, u, v, padded, _, _ = e.run_final(f["fsig"], f["fbuf"])
        refstate[("r", rec["frame_num"])] = tuple(t.clone() for t in padded)
        return tuple(t.clone() for t in (y, u, v))
