"""The decoder's frame program as one CUDA graph per frame signature.

Counterpart of thor_tpu's fused frame program (dec/reconstruct_jax.py:
use_fused :579, _jit_fused :590, _sparse_group :717, _fused_frame :735,
_run_frame :776) and of its count buckets (_pow2pad :46;
dec/native_inputs.py: _Group.pack :82, _pack_sparse :218, pad_tu :545).
thor_tpu jits the whole frame once per frame configuration and input
shapes, and pads every count to a bucket so that a few programs serve
every frame. On the card the counterpart of one jitted program is one
CUDA graph:

  - bucket_inputs pads a frame's inputs (dec/inputs.build_frame_inputs)
    to buckets: each residual group's TUs to powers of 4 from 16 and its
    sparse coefficient pairs to powers of 2 from 64, as thor_tpu does;
    the MC records and the intra TU records (the port's own layouts) to
    powers of 4 from 16, each with its real count. Padded TUs and
    coefficient pairs are no-ops (a zero at index 0 under densify's and
    scatter_tu's adds); the kernels skip padded records, reading the real
    count on the device; the deblocking strengths become 0-d arrays;
  - pack_frame lays the padded arrays out in one host buffer (pinned for
    a card), so that a frame's inputs cross in one copy;
  - run_frame looks the frame's signature (the frame configuration, the
    MC filter set and the layout of the packed arrays, which names every
    group present and every bucket size) up in its lane's part of the
    cache of at most 256 entries (ops/graphs: a lane is the device and
    the current stream; thor_tpu's lru_cache bound; the least recently
    used goes first). A new entry allocates its input buffers on the
    device, runs the frame program once on the lane's side stream
    (PyTorch's graph notes: cuBLAS and the kernels' libraries initialise
    outside a capture), then captures it as a torch.cuda.CUDAGraph into
    the lane's pool. Each frame then copies its packed inputs and its R
    reference planes into the entry's buffers, replays the graph on the
    lane's stream and clones the outputs, all under the lane's lock.

The entries, their buffers and the reference stacks belong to one lane:
the Decoder's main thread dispatches on the device's current stream, and
each slot of the sharded decoder (parallel/mesh.py, under Slot.active)
on its own stream, so its own lane; two threads on one lane take turns
frame by frame. The interpolated reference an RA / HDB frame predicts
from is one more graph, replayed just before the frame's
(ops/interp_fused.py, keyed by size and weights, not folded into the
frame signature). A band of a frame split across tile slots runs the
band programs of parallel/fused.py. The graph machinery (capture,
replay, the cache, its lanes and pools, the launch counts) lives in
ops/graphs.py, whose cache also holds the interpolation entries and the
device encoder's P/B and I-frame programs (enc/fused.py,
enc/fused_intra.py).

On the CPU there is no graph: the same entry runs the frame program on
its buffers through the kernels' plain versions. A capture that fails
raises; nothing falls back to the eager path (dec/reconstruct
.reconstruct_frame, which Decoder(fused=False) runs).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..codec.constants import PAD_C, PAD_Y
from ..ops import graphs as G
from ..ops.interp_fused import entries as interp_entries
from .inputs import FrameConfig
from .reconstruct import mc_luts, reconstruct_frame

TU_MIN = 16         # _pow2pad's first bucket
COEF_MIN = 64       # _sparse_group's first bucket
ALIGN = 16          # byte alignment of each array in a packed frame
INTRA_PAD = (0, 0, 4, 0, 4, 4, 0)   # pad_tu's filler TU (never run)

_TORCH = {"|u1": torch.uint8, "|b1": torch.bool, "<i2": torch.int16,
          "<i4": torch.int32, "<f4": torch.float32}


def pow4_bucket(n: int) -> int:
    """thor_tpu's _pow2pad(max(n, 1)): 16, 64, 256, ..."""
    p = TU_MIN
    while p < n:
        p *= 4
    return p


def pow2_bucket(n: int) -> int:
    """The coefficient pairs' bucket (_pack_sparse): 64, 128, 256, ..."""
    return max(COEF_MIN, 1 << (max(n, 1) - 1).bit_length())


def _pad(a, n, fill):
    out = np.full((n,) + a.shape[1:], fill, np.int32)
    out[:len(a)] = a
    return out


def _bucket_group(g):
    """One residual group: TUs to pow4_bucket, pairs to pow2_bucket."""
    n = pow4_bucket(len(g["y"]))
    k = pow2_bucket(len(g["cidx"]))
    out = {"cidx": _pad(g["cidx"], k, 0), "cval": _pad(g["cval"], k, 0)}
    for key, fill in (("y", 0), ("x", 0), ("f", 1), ("a", 0), ("sh", 1),
                      ("pl", 0)):
        if key in g:
            out[key] = _pad(g[key], n, fill)
    return out


def bucket_inputs(cfg, inp):
    """A frame's inputs (dec/inputs.build_frame_inputs) padded to buckets,
    as numpy arrays: residual groups as _bucket_group; "mc_y" / "mc_c" /
    "it_y" / "it_c" to pow4_bucket rows, with "<name>_n" the real count
    ([1] int32); "beta" / "tc" / "tcC" as 0-d int32 arrays; the side-info
    planes as they are. "mc_clamped", a host count, is left out."""
    out = {}
    for k, v in inp.items():
        if k.startswith(("gy", "gc")):
            out[k] = _bucket_group(v)
        elif k in ("mc_y", "mc_c", "it_y", "it_c"):
            out[k] = _pad(v, pow4_bucket(len(v)),
                          INTRA_PAD if k.startswith("it") else 0)
            out[k + "_n"] = np.array([len(v)], np.int32)
        elif k in ("beta", "tc", "tcC"):
            out[k] = np.array(v, np.int32)
        elif k != "mc_clamped":
            out[k] = v
    return out


def _fields(binp):
    """[(path, array)] of the bucketed inputs in a fixed order."""
    out = []
    for k in sorted(binp):
        v = binp[k]
        if isinstance(v, dict):
            out += [((k, kk), np.asarray(v[kk])) for kk in sorted(v)]
        else:
            out.append(((k,), np.asarray(v)))
    return out


def _offsets(layout):
    """Byte offset of each array of `layout` and the buffer's size."""
    offs, pos = [], 0
    for _, dt, shape in layout:
        offs.append(pos)
        n = int(np.prod(shape, dtype=np.int64)) * np.dtype(dt).itemsize
        pos += -(-n // ALIGN) * ALIGN
    return offs, pos


class Signature(NamedTuple):
    """What a frame's graph depends on besides the device: the frame
    configuration, the MC filter set (the LUT the graph reads) and the
    packed arrays' (path, dtype, shape)."""
    cfg: FrameConfig
    bipred: int
    layout: tuple


class PackedFrame(NamedTuple):
    sig: Signature
    buf: torch.Tensor       # uint8, the arrays at _offsets(sig.layout)

    def to(self, device):
        return PackedFrame(self.sig, self.buf.to(device))


def pack_fields(binp, pin: bool = False):
    """The numpy arrays of `binp` (a dict, nested one level at most) in
    one uint8 buffer, pinned with `pin` (for a copy to a card that the
    host does not wait for): (layout, buffer), the layout being the
    arrays' (path, dtype, shape) in the buffer's order."""
    fields = _fields(binp)
    layout = tuple((path, a.dtype.str, a.shape) for path, a in fields)
    offs, total = _offsets(layout)
    buf = torch.empty(total, dtype=torch.uint8, pin_memory=pin)
    raw = buf.numpy()
    for (_, a), off in zip(fields, offs):
        b = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
        raw[off:off + b.size] = b
    return layout, buf


def pack_frame(cfg, binp, bipred: int, pin: bool = False) -> PackedFrame:
    """The bucketed inputs `binp` in one uint8 buffer (pinned with
    `pin`, for a copy to a card that the host does not wait for)."""
    layout, buf = pack_fields(binp, pin)
    return PackedFrame(Signature(cfg, int(bipred), layout), buf)


def unpack(buf, layout):
    """The arrays of a packed frame as views of `buf` (the frame
    program's input dict: nested for the residual groups)."""
    out = {}
    offs, _ = _offsets(layout)
    for (path, dt, shape), off in zip(layout, offs):
        dtype = _TORCH[dt]
        n = int(np.prod(shape, dtype=np.int64)) * np.dtype(dt).itemsize
        t = buf[off:off + n].view(dtype).view(shape)
        if len(path) == 2:
            out.setdefault(path[0], {})[path[1]] = t
        else:
            out[path[0]] = t
    return out


class _Entry(G.GraphProgram):
    """One frame signature's input buffers, reference stacks and, on a
    card, its graph with the graph's output planes, on one lane."""

    def __init__(self, sig: Signature, ln):
        super().__init__()
        dev = ln.dev
        self.cfg = sig.cfg
        self.luts = mc_luts(sig.bipred, dev)
        _, total = _offsets(sig.layout)
        self.flat = torch.empty(total, dtype=torch.uint8, device=dev)
        self.inp = unpack(self.flat, sig.layout)
        self.stacks = stacks(ln, self.cfg) if self.cfg.R else None

    def input_bytes(self) -> int:
        return self.flat.numel()

    def program(self):
        """The frame program on the entry's buffers: (planes, padded)."""
        return reconstruct_frame(self.cfg, self.inp, None, self.luts,
                                 self.stacks)

    def load(self, pf: PackedFrame, refs):
        """Copy a frame's packed inputs and its reference planes into the
        entry's buffers, on the current stream."""
        self.flat.copy_(pf.buf, non_blocking=True)
        load_stacks(self.stacks, refs)


def load_stacks(st, refs):
    """Stack the R reference objects' padded planes into `st` (stacks())
    on the current stream."""
    if st is not None:
        sy, suv = st
        torch.stack([r.y for r in refs], out=sy[0])
        torch.stack([r.u for r in refs], out=suv[0])
        torch.stack([r.v for r in refs], out=suv[1])


_ref_stacks: dict = {}


def stacks(ln, cfg):
    """The reference stacks of cfg.R slots at cfg's size, shared by the
    entries of lane `ln` (filled under the lane's lock, on its stream).
    Stacks of a lane left with no entry go when new ones are made (an
    entry keeps its own)."""
    key = (ln, cfg.R, cfg.H, cfg.W)
    if key not in _ref_stacks:
        live = {k for k, _ in list(G.CACHE.entries)}
        for k in [k for k in _ref_stacks if k[0] not in live]:
            del _ref_stacks[k]
        H, W, R = cfg.H, cfg.W, cfg.R
        _ref_stacks[key] = (
            torch.empty((1, R, H + 2 * PAD_Y, W + 2 * PAD_Y),
                        dtype=torch.uint8, device=ln.dev),
            torch.empty((2, R, H // 2 + 2 * PAD_C, W // 2 + 2 * PAD_C),
                        dtype=torch.uint8, device=ln.dev))
    return _ref_stacks[key]


def lane_footprint(ln) -> dict:
    """Device bytes the graphs of lane `ln` hold (the decoder's, the
    interpolation's and the encoder's: they share the lane's pool): the
    pool's segments (torch.cuda.memory_snapshot; the graphs'
    intermediates and outputs, which max_memory_allocated does not see
    between replays), the entries' input buffers (of them the
    interpolation entries' two references, "interp_input_bytes"), the
    reference stacks, and the lane's captures, capture ms and replays."""
    pid = G.CACHE.pools.get(ln)
    pool = 0 if pid is None else sum(
        seg["total_size"] for seg in torch.cuda.memory_snapshot()
        if seg["device"] == ln.dev.index
        and tuple(seg["segment_pool_id"]) == tuple(pid))
    mine = G.CACHE.of_lane(ln)
    interp = interp_entries(lane=ln)
    return {"entries": len(mine), "pool_bytes": pool,
            "input_bytes": sum(e.input_bytes() for e in mine),
            "interp_entries": len(interp),
            "interp_input_bytes": sum(e.input_bytes() for e in interp),
            "stack_bytes": sum(t.numel() for (k, *_), ts in
                               list(_ref_stacks.items()) if k is ln
                               for t in ts),
            "captures": ln.captures, "capture_ms": ln.capture_ms,
            "replays": ln.replays}


def footprint(dev) -> dict:
    """lane_footprint summed over the lanes of `dev` that hold an entry,
    with "lanes" (their count) and "per_lane" (each lane's)."""
    per = [lane_footprint(ln) for ln in G.lanes(dev)]
    per = [f for f in per if f["entries"]]
    keys = ("entries", "pool_bytes", "input_bytes", "interp_entries",
            "interp_input_bytes", "stack_bytes")
    out = {k: sum(f[k] for f in per) for k in keys}
    out.update(lanes=len(per), per_lane=per)
    return out


def run_frame(dev, pf: PackedFrame, refs):
    """Decode one frame from its packed inputs on the lane of `dev` (its
    current stream): refs, the R reference objects (codec-padded .y/.u/.v
    uint8 tensors on `dev`) in slot order. Returns (y, u, v) uint8 planes
    and their edge-padded copies (pad 96 luma, 48 chroma), as
    dec/reconstruct.reconstruct_frame; on a card clones that later
    replays leave as they are."""
    ln = G.lane(dev)
    return G.run_cached(ln, pf.sig, lambda: _Entry(pf.sig, ln),
                        lambda e: e.load(pf, refs))
