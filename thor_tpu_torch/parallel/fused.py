"""A frame split across tile slots (tile > 1) as CUDA graphs on the slots.

Counterpart of the row split that XLA's SPMD partitioner makes of
thor_tpu's frame program (thor_tpu/parallel/mesh.py: sharded_reconstruct
:143 jits _batched_frame_fn :70 with row-sharded inputs and outputs). On
the card the counterpart of one jitted program is one CUDA graph per
signature on one slot's lane (ops/graphs: a lane is a device and a
stream, so each slot has its own entries, pool and lock). A banded frame
runs three programs, the stages of parallel/mesh.py's eager banded frame:

  - band, on each band's slot: the residual and block MC (kernel 2) of
    luma rows [r0, r1) (dec/reconstruct.residual_planes, predict_planes)
    on dec/reconstruct.band_inputs, bucketed by dec/fused.bucket_inputs
    with the band's own buckets and packed into one pinned buffer, and
    the whole reference planes stacked on the slot's lane (dec/fused
    .stacks); out: the band's predicted planes and residuals;
  - intra, on the row's tile-0 slot: the bands gathered into the entry's
    whole-frame buffers, then kernel 1 over the whole frame
    (dec/reconstruct.intra_planes), its records bucketed with their
    counts on the card; a frame with no intra TU skips it;
  - filter, on each band's slot: deblocking and CLPF
    (dec/reconstruct.filter_rows) of the band's rows with HALO rows of
    the unfiltered frame above and below, the side-info maps sliced to
    the same rows on the host; out: the band's own rows as uint8, in one
    buffer.

The tile-0 slot then gathers the bands' rows and edge-pads the reference
planes (dec/reconstruct.finish_planes), outside a graph. Every hand-off
between slots goes through parallel/mesh.Made (its rules (a)-(d)), and
every output that a later stage or another slot reads is a clone made on
the producing lane under its lock (ops/graphs.run_cached), so a lane may
replay the same program for the next frame at once. On the CPU the same
entries run their programs without a graph, through the kernels' plain
versions. A capture that fails raises; nothing falls back to the eager
stages (parallel/mesh.sharded_reconstruct(fused=False)).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..dec import fused as DF
from ..dec.decoder import RefFrame
from ..dec.inputs import FrameConfig
from ..dec.reconstruct import (band_inputs, band_rows, filter_rows,
                               finish_planes, intra_planes, mc_luts,
                               predict_planes, residual_planes)
from ..ops import graphs as G
from .mesh import FILTER_KEYS, HALO, Made


class BandSig(NamedTuple):
    """A band program's signature: the band's packed frame signature (its
    FrameConfig has the band's height) and the whole frame's height (the
    reference stacks')."""
    frame: DF.Signature
    H: int


class IntraSig(NamedTuple):
    """The intra program's: the frame size and the packed records'
    layout (their buckets)."""
    H: int
    W: int
    layout: tuple


class FilterSig(NamedTuple):
    """A filter program's: the filters on, the slice's rows h and width
    W, the band's rows (offset o into the slice, count n) and the
    layout of the sliced side-info maps."""
    deblocking: bool
    clpf: bool
    h: int
    W: int
    o: int
    n: int
    layout: tuple


def _i32(*shape, dev):
    return torch.empty(shape, dtype=torch.int32, device=dev)


class _Packed(G.GraphProgram):
    """An entry whose per-frame inputs cross in one packed buffer."""

    def __init__(self, layout, dev):
        super().__init__()
        _, total = DF._offsets(layout)
        self.flat = torch.empty(total, dtype=torch.uint8, device=dev)
        self.inp = DF.unpack(self.flat, layout)

    def input_bytes(self) -> int:
        return self.flat.numel()


class BandEntry(_Packed):
    """A band program: its packed inputs, the lane's reference stacks of
    the whole frame and the MC tables."""

    def __init__(self, sig: BandSig, ln):
        super().__init__(sig.frame.layout, ln.dev)
        self.cfg = sig.frame.cfg
        self.luts = mc_luts(sig.frame.bipred, ln.dev)
        self.stacks = DF.stacks(ln, self.cfg._replace(H=sig.H)) \
            if self.cfg.R else None

    def load(self, buf, refs):
        self.flat.copy_(buf, non_blocking=True)
        DF.load_stacks(self.stacks, refs)

    def program(self):
        """(y, uv, ry, rc) int32 of the band's rows."""
        ry, rc = residual_planes(self.cfg, self.inp, self.flat.device)
        y, uv = predict_planes(self.cfg, self.inp, None, self.luts, ry, rc,
                               self.stacks)
        return y, uv, ry, rc


class IntraEntry(_Packed):
    """The intra program: the gathered whole-frame planes and residuals,
    and the packed intra records with their counts."""

    def __init__(self, sig: IntraSig, ln):
        super().__init__(sig.layout, ln.dev)
        H, W, dev = sig.H, sig.W, ln.dev
        self.y, self.ry = _i32(H, W, dev=dev), _i32(H, W, dev=dev)
        self.uv = _i32(2, H // 2, W // 2, dev=dev)
        self.rc = _i32(2, H // 2, W // 2, dev=dev)

    def input_bytes(self) -> int:
        return super().input_bytes() + 4 * sum(
            t.numel() for t in (self.y, self.ry, self.uv, self.rc))

    def load(self, parts, buf):
        """parts: each band's (y, uv, ry, rc), top to bottom."""
        for k, t in enumerate((self.y, self.uv, self.ry, self.rc)):
            torch.cat([p[k] for p in parts], k % 2, out=t)
        self.flat.copy_(buf, non_blocking=True)

    def program(self):
        """(y, uv) int32 after the intra scan."""
        return intra_planes(self.inp, self.y, self.uv, self.ry, self.rc)


class FilterEntry(_Packed):
    """A filter program: the slice's unfiltered planes and its packed
    side-info maps."""

    def __init__(self, sig: FilterSig, ln):
        super().__init__(sig.layout, ln.dev)
        self.sig = sig
        h, W, dev = sig.h, sig.W, ln.dev
        self.y = _i32(h, W, dev=dev)
        self.uv = _i32(2, h // 2, W // 2, dev=dev)
        self.cfg = FrameConfig(W, h, 0, sig.deblocking, sig.clpf)

    def input_bytes(self) -> int:
        return super().input_bytes() + 4 * (self.y.numel()
                                            + self.uv.numel())

    def load(self, planes, buf):
        y, u, v = planes
        self.y.copy_(y)
        self.uv[0].copy_(u)
        self.uv[1].copy_(v)
        self.flat.copy_(buf, non_blocking=True)

    def program(self):
        """The band's filtered rows, uint8, Y then U then V in one
        buffer."""
        o, n = self.sig.o, self.sig.n
        y, u, v = filter_rows(self.cfg, self.inp, self.y, self.uv[0],
                              self.uv[1])
        return torch.cat([y[o:o + n].reshape(-1),
                          u[o // 2:(o + n) // 2].reshape(-1),
                          v[o // 2:(o + n) // 2].reshape(-1)]).to(torch.uint8)


def _pin(dev) -> bool:
    return dev.type == "cuda"


def run_band(dev, H: int, pf: DF.PackedFrame, refs):
    """The band program of packed band inputs `pf` on the lane of `dev`:
    refs the R whole reference objects, H the frame's height. Returns
    (y, uv, ry, rc) int32 of the band's rows."""
    ln = G.lane(dev)
    sig = BandSig(pf.sig, H)
    return G.run_cached(ln, ("band", sig), lambda: BandEntry(sig, ln),
                        lambda e: e.load(pf.buf, refs))


def run_intra(dev, cfg, inp, parts):
    """The intra program of a frame's host inputs `inp` on the lane of
    `dev`, over the bands' parts (each (y, uv, ry, rc) on `dev`, top to
    bottom): (y, uv) int32."""
    rec = DF.bucket_inputs(cfg, {k: inp[k] for k in ("it_y", "it_c")})
    layout, buf = DF.pack_fields(rec, pin=_pin(dev))
    ln = G.lane(dev)
    sig = IntraSig(cfg.H, cfg.W, layout)
    return G.run_cached(ln, ("band_intra", sig), lambda: IntraEntry(sig, ln),
                        lambda e: e.load(parts, buf))


def filter_fields(cfg, inp, a: int, b: int):
    """The side-info maps of luma rows [a, b) for filter_rows (a a
    multiple of 64), as pack_fields takes them: the deblocking strengths
    as 0-d int32 arrays."""
    out = {}
    for k in FILTER_KEYS:
        if k not in inp:
            continue
        v = inp[k]
        if k == "ddp":
            v = v[a // 4:b // 4]
        elif k.startswith("m8"):
            v = v[a // 8:b // 8]
        out[k] = np.array(v, np.int32) if k in ("beta", "tc", "tcC") \
            else np.ascontiguousarray(v)
    return out


def run_filter(dev, cfg, inp, a: int, b: int, r0: int, r1: int, planes):
    """The filter program on the lane of `dev`: planes the unfiltered
    (y, u, v) int32 rows [a, b) (chroma halved) of the frame, [r0, r1)
    the band's rows inside them. Returns the band's filtered (y, u, v)
    uint8 rows."""
    layout, buf = DF.pack_fields(filter_fields(cfg, inp, a, b),
                                 pin=_pin(dev))
    ln = G.lane(dev)
    sig = FilterSig(bool(cfg.deblocking), bool(cfg.clpf), b - a, cfg.W,
                    r0 - a, r1 - r0, layout)
    flat = G.run_cached(ln, ("band_filter", sig), lambda: FilterEntry(sig, ln),
                        lambda e: e.load(planes, buf))
    n, W = r1 - r0, cfg.W
    ny, nc = n * W, (n // 2) * (W // 2)
    return (flat[:ny].view(n, W), flat[ny:ny + nc].view(n // 2, W // 2),
            flat[ny + nc:].view(n // 2, W // 2))


def reconstruct_banded(row, cfg, inp, refs, bipred: int):
    """One frame across the tile slots of `row` on their lanes (see the
    module notes). inp: the host inputs of dec/inputs.build_frame_inputs;
    refs: Made padded planes per reference slot; bipred: the MC filter
    set. Returns (planes, padded) as Made on the row's tile-0 slot."""
    s0 = row[0]
    H = cfg.H
    bands = [(r0, r1, s) for (r0, r1), s in zip(band_rows(H, len(row)), row)
             if r1 > r0]
    parts = []
    for r0, r1, s in bands:
        bcfg = cfg._replace(H=r1 - r0)
        pf = DF.pack_frame(bcfg, DF.bucket_inputs(
            bcfg, band_inputs(inp, r0, r1)), bipred, pin=_pin(s.device))
        with s.active():
            rr = [RefFrame(*m.on(s), None) for m in refs]
            parts.append(Made(run_band(s.device, H, pf, rr), s))
    with s0.active():
        got = [p.on(s0) for p in parts]
        if "it_y" in inp:
            y, uv = run_intra(s0.device, cfg, inp, got)
        else:
            y, uv = (torch.cat([g[k] for g in got], k) for k in range(2))
        u, v = uv[0], uv[1]
        if not (cfg.deblocking or cfg.clpf):
            planes, padded = finish_planes(y, u, v)
            return Made(planes, s0), Made(padded, s0)
        slices = []
        for r0, r1, s in bands:
            a, b = max(0, r0 - HALO), min(H, r1 + HALO)
            slices.append((a, b, Made((y[a:b], u[a // 2:b // 2],
                                       v[a // 2:b // 2]), s0)))
    kept = []
    for (r0, r1, s), (a, b, sl) in zip(bands, slices):
        with s.active():
            kept.append(Made(run_filter(s.device, cfg, inp, a, b, r0, r1,
                                        sl.on(s)), s))
    with s0.active():
        got = [k.on(s0) for k in kept]
        planes, padded = finish_planes(*(torch.cat([g[i] for g in got])
                                         for i in range(3)))
        return Made(planes, s0), Made(padded, s0)
