"""The device encoder's I frame as two CUDA graphs and two host waits.

Counterpart of thor_tpu's jitted I frame (thor_tpu/enc/device_intra.py:
the per-size searches, _search_frame_fn :156, one jit per block size; the
luma and chroma scans, _encode_scan_fn :433). On the card the counterpart
of one jitted program is one CUDA graph. An I frame runs two:

  - search: the mode search of the four block sizes with the intra
    quantizer (enc/device_intra.search_intra_frame_dev), the eight mode
    and cost maps packed into one buffer, which the host fetches at once;
  - final: kernel 6 over the walk's luma and chroma records, padded to a
    bucket that never shrinks with the real count on the card (as the P/B
    final program runs it); the cbp of every leaf from its levels, which
    patches the side-info map and makes the CLPF candidate masks; then
    enc/fused.filter_tail (deblocking, the CLPF decision and filter, the
    uint8 and padded reference planes); and one buffer of what the host
    fetches: the uint8 planes, the CLPF decisions and the levels.

Between them the host makes the split decisions and the quadtree walk
(device_intra.intra_split_decisions, _walk_tree, scan_records) and fills
the side-info map from the walk's leaves (device_intra.store_leaf_map:
every field but the cbp is the leaf's geometry, so the program patches
the cbp bit from its levels and deblocks on the emit's map). After the
final fetch the host emits the block syntax from the fetched levels
(device_intra.emit_intra_frame, which rewrites the map as it goes), and
the encoder writes the CLPF bits from the fetched decisions
(Encoder._filters_done).

Entries. One entry per search signature (the geometry, the speed, the
intra mode count and the two QPs, which the ops read as Python numbers)
and lane (ops/graphs: the device and the current stream; each clone of
the sharded encoder has its slot's) lives in ops/graphs' CACHE beside the
decoder's and the P/B encoder's entries, sharing the lane's graph pool
and side stream. It holds the original planes, the lambda (a float32 on
the card) and up to enc/fused.FINALS final programs by their signature
(the filters and the layout of the packed inputs, which names the record
buckets). The final reads the search's outputs in place, so a frame
holds the lane's lock from its search's load to its final's fetch.

Encoder(fused=True), the default, runs these; fused=False runs
device_intra.encode_intra_frame_device and Encoder._filters. On the CPU
the same entries run their programs without a graph, through the kernels'
plain versions. A capture that fails raises and leaves no entry (a search
entry) or no final program behind; nothing falls back to the eager path.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from ..codec.constants import CHROMA_QP, MAX_BLOCK_SIZE
from ..dec import fused as DF
from ..ops import graphs as G, kernels as K
from ..ops.enc_intra import encode_scan
from ..ops.intra import NF as INTRA_NF
from ..utils.tracing import span
from . import fused as FU
from .device_intra import (_walk_tree, emit_intra_frame,
                           intra_split_decisions, scan_records,
                           search_intra_frame_dev, store_leaf_map)

I32 = torch.int32
SIZES = (8, 16, 32, 64)


class IntraSig(NamedTuple):
    """What an I frame's search program depends on besides the device."""
    H: int
    W: int
    fast: bool
    nmodes: int
    qpY: int
    qpC: int


class IntraFinalSig(NamedTuple):
    deblocking: bool
    clpf: bool
    layout: tuple


def search_program(e):
    """The mode searches of every block size on the entry's buffers:
    (flat, layout), flat holding the eight maps."""
    sig = e.sig
    maps = search_intra_frame_dev(*e.org, sig.qpY, sig.qpC, e.small_in["lam"],
                                  sig.W, sig.H, sig.fast, sig.nmodes,
                                  intra_quant=True)
    return FU._as_bytes([((s, j), maps[s][j]) for s in SIZES
                         for j in (0, 1)])


def final_program(e, f):
    """The scans, the filters and the fetch buffer of one I frame on the
    entry's buffers and f's inputs: (y, u, v uint8, (Y, U, V) padded,
    flat, layout), flat holding the planes, the CLPF decisions and
    candidate masks, the levels and, with deblocking, the patched
    side-info map."""
    sig, inp = e.sig, f.inp
    H, W = sig.H, sig.W
    dev = e.oy.device
    y, q16y = encode_scan(torch.zeros((1, H, W), dtype=I32, device=dev),
                          e.oy[None], inp["it_y"], sig.qpY, sig.fast, True,
                          count=inp["it_n"])
    uv, q16c = encode_scan(
        torch.zeros((2, H // 2, W // 2), dtype=I32, device=dev), e.oc,
        inp["it_c"], sig.qpC, sig.fast, True, count=inp["it_n"])
    # each leaf's cbp (bit j: plane j) from its levels, then the cbp of
    # every 8x8 cell from the leaf that owns it
    bits = sum((q != 0).any(dim=(1, 2)).to(I32) << j for j, q in
               enumerate((q16y[:, 0], q16c[:, 0], q16c[:, 1])))
    got = bits[(inp["own8"] - 1).long()]
    ddp = inp.get("ddp")
    if ddp is not None:
        cbpy4 = (got & 1).repeat_interleave(2, 0).repeat_interleave(2, 1)
        ddp = (ddp & 0xFD) | (cbpy4 << 1).to(torch.uint8)
    SBH, SBW = H // MAX_BLOCK_SIZE, W // MAX_BLOCK_SIZE
    cm = torch.zeros((3, H // 8, W // 8), dtype=torch.bool, device=dev)
    cm[:, :SBH * 8, :SBW * 8] = torch.stack(
        [(got >> j) & 1 != 0 for j in range(3)])[:, :SBH * 8, :SBW * 8]
    y, u, v, bit_sb, padded = FU.filter_tail(
        y[0], uv[0], uv[1], e.oy, ddp, cm, sig.qpY, H, W, f.sig.deblocking,
        f.sig.clpf)
    flat, layout = FU._as_bytes(
        [(("y",), y), (("u",), u), (("v",), v), (("bit_sb",), bit_sb),
         (("cm",), cm), (("q16y",), q16y), (("q16c",), q16c)]
        + ([(("ddp",), ddp)] if ddp is not None else []))
    return y, u, v, padded, flat, layout


class IntraEntry:
    """One search signature's input buffers and programs on one lane (see
    the module notes)."""

    def __init__(self, sig: IntraSig, ln):
        H, W = sig.H, sig.W
        self.sig, self.lane, self.dev = sig, ln, ln.dev
        dev = ln.dev
        self.oy = torch.empty((H, W), dtype=I32, device=dev)
        self.oc = torch.empty((2, H // 2, W // 2), dtype=I32, device=dev)
        self.org = (self.oy, self.oc[0], self.oc[1])
        lay, _ = DF.pack_fields(small_fields(0.0))
        self.small = torch.empty(DF._offsets(lay)[1], dtype=torch.uint8,
                                 device=dev)
        self.small_in = DF.unpack(self.small, lay)
        self.search = G.GraphProgram()
        self.finals: OrderedDict = OrderedDict()
        self.caps: dict = {}        # final input -> its bucket (FU._bucket)

    @property
    def graph(self):
        """A graph of the entry, if it holds one (ops/graphs.FrameCache)."""
        return self.search.graph

    def input_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (
            self.oy, self.oc, self.small)) \
            + sum(f.flat.numel() for f in self.finals.values())

    def run_search(self, org, small):
        """Load a frame's original planes (y, u, v) and its packed lambda,
        then run the search program."""
        for dst, src in zip(self.org, org):
            dst.copy_(src)
        self.small.copy_(small, non_blocking=True)
        return self.search.run(self.lane, lambda: search_program(self))

    def run_final(self, fsig: IntraFinalSig, buf):
        """Load a frame's packed final inputs and run the final program of
        their signature (after run_search of the same frame)."""
        return FU.run_final_of(self, fsig, buf, final_program)


def small_fields(lam):
    """The search program's per-frame number, as pack_fields takes it."""
    return {"lam": np.array(lam, np.float32)}


def run_search(dev, sig, org, small):
    """IntraEntry.run_search on the cache's entry of sig on the lane of
    `dev` (its current stream), made at its first use: (entry, (flat,
    layout)). A new entry whose first run fails leaves the cache again.
    The caller holds the lane's lock through the frame's final."""
    ln = G.lane(dev)
    key = (ln, ("intra", sig))
    e, fresh = G.CACHE.get(key, lambda: IntraEntry(sig, ln))
    try:
        return e, e.run_search(org, small)
    except BaseException:
        if fresh:
            G.CACHE.discard(key)
        raise


def final_inputs(e, tus, dd, W, H, deblocking):
    """The final program's packed inputs from the walk's leaves: the luma
    and chroma records (bucketed, with their count), the 8x8 cells each
    leaf owns (1-based), and with deblocking the side-info map of the
    leaves (store_leaf_map into dd)."""
    ry, rc = scan_records(tus, W, H)
    inp = {}
    inp["it_y"], inp["it_n"] = FU._bucket(e, "it", ry, DF.INTRA_PAD,
                                          INTRA_NF)
    inp["it_c"], _ = FU._bucket(e, "it", rc, DF.INTRA_PAD, INTRA_NF)
    inp["own8"] = store_leaf_map(dd, tus)
    if deblocking:
        inp["ddp"] = K.pack_ddp(vars(dd))
    return inp


def encode_intra_frame_fused(enc, w, org_y, org_u, org_v):
    """The I frame on the two programs: search (one fetch), the host's
    split decisions and walk, final (one fetch), the emit. org_*: int32
    planes on the encoder's device. Returns {"planes": (y, u, v) uint8 on
    the device, "padded": the reference's planes, "host": the planes
    fetched, "bit_sb": the CLPF decision per superblock, "cm": the CLPF
    candidate masks, "ddp": the patched side-info map the program
    deblocked on (None without deblocking); all but the first two
    fetched}, as
    enc/fused.finish_frame does for a P/B frame; Encoder._filters_done
    takes it. Records the host-clock seconds of "search" (up to the
    walk), "scan" (the final program with the filters, up to its fetch)
    and "emit", and "tus", in enc.frame_times[-1]. Spans: enc.search (of
    it enc.search.program, .fetch and .walk: the split decisions and the
    tree walk), enc.scan (of it enc.scan.inputs, .program and .fetch) and
    enc.emit."""
    W, H = enc.width, enc.height
    p = enc.params
    dev = org_y.device
    pin = dev.type == "cuda"
    times = enc.frame_times[-1]
    qpY = enc.frame_qp
    sig = IntraSig(H, W, p.encoder_speed > 1, int(enc.num_intra_modes), qpY,
                   int(CHROMA_QP[qpY]))
    org = (org_y, org_u, org_v)
    with G.lane(dev).lock:
        with span("enc.search", times, "search"):
            _, small = DF.pack_fields(small_fields(enc.lambda_), pin=pin)
            with span("enc.search.program"):
                e, (flat, layout) = run_search(dev, sig, org, small)
            with span("enc.search.fetch"):
                got = FU.host_maps(FU.fetch(flat), layout)
            with span("enc.search.walk"):
                modes, split = intra_split_decisions(
                    {s: (got[(s, 0)], got[(s, 1)]) for s in SIZES}, W, H)
                tus = _walk_tree(split, modes, W, H)

        with span("enc.scan", times, "scan"):
            with span("enc.scan.inputs"):
                inp = final_inputs(e, tus, enc.deblock_data, W, H,
                                   bool(p.deblocking))
                layout, buf = DF.pack_fields(inp, pin=pin)
            fsig = IntraFinalSig(bool(p.deblocking), bool(p.clpf), layout)
            with span("enc.scan.program"):
                y, u, v, padded, flat, flayout = e.run_final(fsig, buf)
                planes = tuple(t.clone() for t in (y, u, v))
                padded = tuple(t.clone() for t in padded)
            with span("enc.scan.fetch"):
                got = FU.host_maps(FU.fetch(flat), flayout)
    n = len(tus)
    q16c = got[("q16c",)]
    times["tus"] = n
    if enc.intra_record is not None:
        enc.intra_record.append(
            {"frame_num": enc.frame_num, "org": org,
             "fused": {"sig": sig, "small": small, "fsig": fsig,
                       "fbuf": buf}})
    with span("enc.emit", times, "emit"):
        enc.deblock_data.reset()
        emit_intra_frame(enc, w, tus, got[("q16y",)][:n, 0], q16c[:n, 0],
                         q16c[:n, 1])
    return {"planes": planes, "padded": padded, "bit_sb": got[("bit_sb",)],
            # copied out of the pinned fetch buffer: a sequence's
            # reconstructions outlive it
            "host": tuple(got[(c,)].copy() for c in "yuv"),
            "cm": got[("cm",)], "ddp": got.get(("ddp",))}


def replay_intra_frame(rec):
    """Run one recorded I frame's device work again and return its (y, u,
    v) uint8 reconstruction: on the fused path its two programs from the
    record's packed inputs (the search's maps are not fetched); stage by
    stage the search, the two scans on the recorded records and the
    filters on the recorded side-info map, with the CLPF decision on the
    card. No host wait."""
    org = rec["org"]
    f = rec["fused"]
    if f is not None:
        with G.lane(org[0].device).lock:
            e, _ = run_search(org[0].device, f["sig"], org, f["small"])
            y, u, v = e.run_final(f["fsig"], f["fbuf"])[:3]
            return tuple(t.clone() for t in (y, u, v))
    from .device_inter import _replay_filters
    H, W, fast = rec["H"], rec["W"], rec["fast"]
    dev = org[0].device
    search_intra_frame_dev(*org, rec["qpY"], rec["qpC"], rec["lam"], W, H,
                           fast, rec["nmodes"])
    y, _ = encode_scan(torch.zeros((1, H, W), dtype=I32, device=dev),
                       org[0][None], rec["recs"][0], rec["qpY"], fast, True)
    uv, _ = encode_scan(torch.zeros((2, H // 2, W // 2), dtype=I32,
                                    device=dev), torch.stack(org[1:]),
                        rec["recs"][1], rec["qpC"], fast, True)
    return tuple(t.to(torch.uint8) for t in
                 _replay_filters(rec, y[0], uv[0], uv[1], org[0]))

