"""The interpolated reference as one CUDA graph per signature.

Counterpart of thor_tpu's jitted interpolation (ops/pallas_interp.py:
interpolate_frames_pallas :647 over the jitted me_level_pallas :380,
mot_comp_pallas :612 and mot_comp_pallas_uv :574; ops/device_interp.py:
_upscale_fn :398, _mot_comp_fn :412). On the card the counterpart of one
jitted program is one CUDA graph: the pyramid of both references, the
four guided ME levels with the MV upscales between them (kernel 3) and
the synthesis of the three padded planes (kernels 4-5), the program of
ops/interp.interpolate_frames on the entry's input buffers.

An entry lives in ops/graphs' CACHE beside the decoder's frame entries and
the encoder's entries, keyed by (lane, ("interp", W, H, wt0, wt1)): the
lane is the device and the current stream, so each slot of the sharded
paths has its own entries. The weights belong in the signature: me_level
and mot_comp_uv pass them to their kernels as scalars, which a capture
bakes in. The reversed path (pos > ratio / 2) is folded into the weights
and the order in which the references are loaded. An entry holds both
references' padded planes in one buffer, which a frame fills with one
copy on the lane's stream; the graph writes the three padded planes into
one output buffer, which run_interp clones (one copy), all under the
lane's lock: the interpolated reference outlives the next replay (the
decoder's interp_frame and its snapshots, the encoder's interp_frame and
the references of its device records, a sharded frame's reference on its
tile-0 slot).

Decoder(fused=True), Encoder(fused=True), ShardedDecoder(fused=True) and
ShardedEncoder(fused=True) call run_interp; fused=False and the numpy
backend call interpolate_frames. On the CPU there is no graph: the same
entry runs the program on its buffers through the kernels' plain
versions. A capture that fails raises and leaves no entry; nothing falls
back to the eager function.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import graphs as G
from .interp import (PAD_C, PAD_Y, build_pyramid, estimate_motion,
                     interp_weights, num_levels, synthesize)


class InterpSig(NamedTuple):
    """What an interpolated reference's graph depends on besides the
    device: the frame size and the weights (wt0, wt1)."""
    W: int
    H: int
    wt0: int
    wt1: int


class _Planes:
    __slots__ = ("y", "u", "v")

    def __init__(self, y, u, v):
        self.y, self.u, self.v = y, u, v


def _plane_shapes(W, H):
    return ((H + 2 * PAD_Y, W + 2 * PAD_Y),
            (H // 2 + 2 * PAD_C, W // 2 + 2 * PAD_C),
            (H // 2 + 2 * PAD_C, W // 2 + 2 * PAD_C))


def _views(flat, shapes):
    """Consecutive views of `flat` with the given 2-D shapes."""
    out, pos = [], 0
    for h, w in shapes:
        out.append(flat[pos:pos + h * w].view(h, w))
        pos += h * w
    return out


class InterpEntry(G.GraphProgram):
    """One signature's input buffer (both references' padded Y, U, V) and,
    on a card, its graph with the graph's output buffer."""

    def __init__(self, sig: InterpSig, dev):
        super().__init__()
        self.sig = sig
        self.shapes = _plane_shapes(sig.W, sig.H)
        n = sum(h * w for h, w in self.shapes)
        self.flat = torch.empty(2 * n, dtype=torch.uint8, device=dev)
        p = _views(self.flat, self.shapes * 2)
        self.refs = (_Planes(*p[:3]), _Planes(*p[3:]))

    def input_bytes(self) -> int:
        return self.flat.numel()

    def load(self, ref0, ref1):
        """Copy the two references' padded planes (ref0 first, as the
        weights' order has them) into the input buffer, one copy on the
        current stream."""
        torch.cat([p.reshape(-1) for r in (ref0, ref1)
                   for p in (r.y, r.u, r.v)], out=self.flat)

    def program(self):
        """The pyramid, the guided levels and the synthesis on the entry's
        buffers: the three padded planes in one uint8 buffer."""
        W, H, wts = self.sig.W, self.sig.H, (self.sig.wt0, self.sig.wt1)
        r0, r1 = self.refs
        levels = num_levels(W, H)
        maps = estimate_motion(build_pyramid(r0.y, W, H, levels),
                               build_pyramid(r1.y, W, H, levels), W, H, wts)
        out = synthesize(r0, r1, maps, wts, W, H)
        return torch.cat([p.reshape(-1) for p in out[3:]])


def signature(ref0, ref1, ratio: int, pos: int):
    """(InterpSig, the references in the order the program reads them)."""
    rev, wt0, wt1 = interp_weights(ratio, pos)
    if rev:
        ref0, ref1 = ref1, ref0
    h, w = ref0.y.shape[0] - 2 * PAD_Y, ref0.y.shape[1] - 2 * PAD_Y
    return InterpSig(w, h, wt0, wt1), ref0, ref1


def run_interp(dev, ref0, ref1, ratio: int, pos: int):
    """interpolate_frames(ref0, ref1, ratio, pos) through the entry of its
    signature on the lane of `dev` (its current stream): (y, u, v, yp, up,
    vp), the three padded planes and views of their interiors, on a card
    a copy of the graph's outputs that later replays leave as they are.
    The host waits for nothing."""
    ln = G.lane(dev)
    sig, ref0, ref1 = signature(ref0, ref1, ratio, pos)
    flat = G.run_cached(ln, ("interp",) + tuple(sig),
                        lambda: InterpEntry(sig, ln.dev),
                        lambda e: e.load(ref0, ref1))
    yp, up, vp = _views(flat, _plane_shapes(sig.W, sig.H))
    H, W = sig.H, sig.W
    return (yp[PAD_Y:PAD_Y + H, PAD_Y:PAD_Y + W],
            *(p[PAD_C:PAD_C + H // 2, PAD_C:PAD_C + W // 2]
              for p in (up, vp)), yp, up, vp)


def entries(dev=None, lane=None):
    """The cache's interpolation entries (of lane `lane`, of the lanes of
    `dev`, or of every lane)."""
    dev = None if dev is None else G.device(dev)
    with G.CACHE.mutex:
        return [e for (ln, _), e in G.CACHE.entries.items()
                if isinstance(e, InterpEntry)
                and (lane is None or ln is lane)
                and (dev is None or ln.dev == dev)]
