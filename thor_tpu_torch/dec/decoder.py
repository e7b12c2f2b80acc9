"""Top-level decoder: stream framing, the sliding reference window,
reorder to display order (dec/maindec.c:91-195, dec/decode_frame.c:45-148).

Two backends, as in thor_tpu dec/decoder.py:
  - "torch" (the default), pipelined like thor_tpu dec/decoder.py:222-356:
      - a parse thread runs the serial entropy parse (the native C parse,
        or the instrumented Python FrameParser laid out as the C parse's
        frame by dec/syntax_inputs.py), tracking the window of reference
        display numbers itself;
      - a small worker pool builds each parsed frame's inputs ahead of
        time (and, stage by stage, copies them to the device);
      - the main thread queues the frame program and materializes output
        _DEPTH frames behind the dispatch front (each frame's device->host
        copy is queued right after its program, into pinned memory, and
        waited for only when yielded). With fused=True (the default, as
        thor_tpu's use_fused()) the workers pad each frame's inputs to
        buckets and pack them into one pinned buffer, and the frame program
        is one CUDA graph per frame signature (dec/fused.py): the main
        thread copies the buffer and the reference planes into the graph's
        inputs and replays it. fused=False queues the frame program's
        stages one by one (dec/reconstruct.reconstruct_frame), as
        thor_tpu's THOR_FUSED=0 runs _staged_frame.
    The reference window (33 frames, codec-padded) stays on the device, and
    so does the interpolated reference of RA / HDB streams: it is
    synthesized from two window frames on the same stream, just before the
    frame program that predicts from it; with fused=True as one CUDA graph
    per (size, weights) signature (ops/interp_fused.py), with fused=False
    stage by stage (ops/interp.py).
  - "numpy": thor_tpu's serial host loop (dec/decoder.py:176-219,
    :427-488), the exact host oracle: dec/reconstruct_np.py on host
    reference planes, the interpolated reference from the C copy
    (ops/temporal_interp.py). It touches no device.

With collect_stats the parse is the Python FrameParser, which counts what
Thordec's statistics report prints (dec/maindec.c:197-329; dec/__main__.py).
"""

from __future__ import annotations

import queue
import threading
import warnings
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from itertools import chain
from typing import Optional

import numpy as np
import torch

from ..bitstream.reader import BitReader, iter_frames
from ..codec.constants import (
    MAX_REF_FRAMES, MAX_REORDER_BUFFER, MODE_BIPRED, MODE_INTER, PAD_C, PAD_Y)
from ..device import resolve_device
from ..native import lib, parse_frame, seqhdr_from_python
from ..ops import interp, temporal_interp
from ..ops.interp_fused import run_interp
from . import fused as F
from .inputs import build_frame_inputs
from .native_adapter import native_parse_to_syntax
from .parse import FrameParser, SequenceHeader
from .reconstruct import mc_luts, reconstruct_frame, to_device
from .reconstruct_np import RefFrame as NpRefFrame
from .reconstruct_np import apply_clpf
from .reconstruct_np import reconstruct_frame as reconstruct_frame_np
from .syntax_inputs import syntax_to_native

_DEPTH = 2      # frames in flight between dispatch and output
BACKENDS = ("torch", "numpy")
PARSERS = ("native", "python")
FRAME_TYPES = {0: "I", 1: "P", 2: "B"}


class RefFrame:
    """Codec-padded reference planes (uint8 tensors) and display number."""

    __slots__ = ("y", "u", "v", "frame_num")

    def __init__(self, y, u, v, frame_num):
        self.y, self.u, self.v = y, u, v
        self.frame_num = frame_num


def needs_interp(fh) -> bool:
    """The frame predicts from a temporally interpolated reference
    (dec/decode_frame.c:91-109)."""
    return bool(fh.interp_ref_frame and fh.num_ref > 2
                and fh.ref_array[0] == -1)


def interp_pair(refs, fh):
    """(r1, r2, ratio, pos): the two frames of the window `refs` that
    frame `fh`'s interpolated reference is made from and where it lies
    between them (dec/decode_frame.c:91-109)."""
    dfn = fh.display_frame_num
    r1 = refs[fh.ref_array[1]]
    r2 = refs[fh.ref_array[2]]
    off1 = r2.frame_num - dfn
    off2 = dfn - r1.frame_num
    if off1 < 0 and off2 < 0:
        off1, off2 = -off1, -off2
    if off1 == off2:
        off1 = off2 = 1
    return r1, r2, off1 + off2, off2


def frame_digest_np(y, u, v):
    """Host twin of the device digest (_Digest) over (y, u, v) planes (the
    packed layout is y on top, u|v below): the position-weighted sum
    sum(p[i] * (2i + 1)) mod 2^32 (thor_tpu dec/decoder.py:70-77)."""
    packed = np.vstack([y, np.hstack([u, v])])
    val = packed.reshape(-1).astype(np.uint32)
    i = np.arange(val.size, dtype=np.uint32)
    return np.uint32(np.sum(val * (2 * i + 1), dtype=np.uint32))


def new_stats() -> dict:
    """An empty bit_count_t analogue (dec/maindec.c:197-329)."""
    return {"frame_type": {}, "mode": {}, "size": {}, "size_mode": {},
            "frame_bits": {}, "cats": {}, "size_ref": {}, "bi_ref": {},
            "super_stat": {}, "num_ref_max": 0, "seq_header": 0}


def count_frame(st: dict, fs, nbits: int):
    """Add one parsed frame to the statistics `st` (thor_tpu
    dec/decoder.py:444-470). nbits: the payload's bits, the sequence
    header's included on the first frame."""
    ft = FRAME_TYPES[fs.stat_frame_type]
    st["frame_type"][ft] = st["frame_type"].get(ft, 0) + 1
    st["frame_bits"][ft] = st["frame_bits"].get(ft, 0) + nbits
    if fs.bit_cats:
        for cat, v in fs.bit_cats.items():
            st["cats"][(ft, cat)] = st["cats"].get((ft, cat), 0) + v
    st["num_ref_max"] = max(st["num_ref_max"], fs.num_ref)
    for b in fs.blocks:
        # counts in 8x8 units like bit_count_t (dec/maindec.c:240+)
        n8 = (b.bwidth // 8) * (b.bheight // 8)
        key = (ft, b.mode)
        st["mode"][key] = st["mode"].get(key, 0) + n8
        skey = (ft, b.size)
        st["size"][skey] = st["size"].get(skey, 0) + n8
        smkey = (ft, b.size, b.mode)
        st["size_mode"][smkey] = st["size_mode"].get(smkey, 0) + n8
        # size_and_ref_idx / bi_ref in block units
        # (dec/read_bits.c:389, :526)
        if b.mode == MODE_INTER:
            rk = (ft, b.size, b.ref_idx0)
            st["size_ref"][rk] = st["size_ref"].get(rk, 0) + 1
        elif b.mode == MODE_BIPRED:
            bk = (ft, b.ref_idx0 * fs.num_ref + b.ref_idx1)
            st["bi_ref"][bk] = st["bi_ref"].get(bk, 0) + 1
    for (sz, code) in (fs.super_stat or ()):
        sk = (ft, sz, code)
        st["super_stat"][sk] = st["super_stat"].get(sk, 0) + 1


class _Output:
    """One decoded frame on its way to the host."""

    __slots__ = ("planes", "event")

    def __init__(self, planes):
        if planes[0].device.type == "cuda":
            self.planes = tuple(
                torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
                .copy_(p, non_blocking=True) for p in planes)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.planes, self.event = planes, None

    def get(self):
        if self.event is not None:
            self.event.synchronize()
        return tuple(p.numpy() for p in self.planes)


class _Digest:
    """The uint32 checksum of one decoded frame (frame_digest_np's value),
    summed on the frame's device in int64, which holds a 1080p frame's sum
    exactly (below 2^53), then masked to 32 bits. Only the 8-byte sum
    crosses to the host."""

    __slots__ = ("value", "event")

    def __init__(self, planes, weights):
        y, u, v = planes
        packed = torch.cat([y.reshape(-1), torch.cat([u, v], 1).reshape(-1)])
        s = (packed.to(torch.int64) * weights).sum()
        if s.device.type == "cuda":
            self.value = torch.empty((), dtype=torch.int64, pin_memory=True) \
                .copy_(s, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.value, self.event = s, None

    def get(self):
        if self.event is not None:
            self.event.synchronize()
        return np.uint32(int(self.value) & 0xFFFFFFFF)


class _Reorder:
    """Display-order release of decoded frames (dec/maindec.c:167-195)."""

    def __init__(self, next_display: int):
        self.slots: dict = {}
        self.last = next_display - 1

    def put(self, display_num: int, item) -> list:
        """Store frame `display_num`; return the frames now due, in order."""
        self.slots[display_num % MAX_REORDER_BUFFER] = item
        due = []
        while (self.last + 1) % MAX_REORDER_BUFFER in self.slots:
            self.last += 1
            due.append(self.slots.pop(self.last % MAX_REORDER_BUFFER))
        return due


class Decoder:
    """Decodes Thor streams.

    backend "torch" runs the frame program on `device` ("cuda" by default;
    "cpu" runs the kernels' plain versions), by default as one CUDA graph
    per frame signature on bucketed inputs (`fused`, dec/fused.py; on the
    CPU the same bucketed program without a graph), with fused=False
    stage by stage; "numpy" runs thor_tpu's host oracle and uses no
    device (`device` and `fused` are not used). parse "native" is the
    C parse, "python" the instrumented FrameParser; collect_stats forces
    "python" and fills `stats` (the counts Thordec's report prints).

    `mc_clamped` counts the MC cell windows that left the padded reference
    plane and were clamped into it (ops/mc.py:build_mc_records); a valid
    stream has none. `interp_frame` is the newest interpolated reference
    (padded planes, numbered as the frame it was made for), or None.
    `pending` lists window frames a loaded snapshot had decoded but not yet
    output; the next decode_payloads call puts them out in their display
    order."""

    def __init__(self, device=None, backend: str = "torch",
                 collect_stats: bool = False, parse: str = "native",
                 fused: bool = True):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}")
        if parse not in PARSERS:
            raise ValueError(f"parse must be one of {PARSERS}")
        self.backend = backend
        self.fused = fused
        # the bit statistics need the instrumented Python parser
        self.device = resolve_device(device) if backend == "torch" else None
        self.parse_mode = "python" if collect_stats else parse
        if self.parse_mode == "native":
            lib()               # a C parse that fails to build raises here
        self.stats = new_stats() if collect_stats else None
        self.seq: Optional[SequenceHeader] = None
        self.refs = [None] * MAX_REF_FRAMES
        self.interp_frame = None
        self.pending = []
        self.next_display = 0
        self.mc_clamped = 0
        self._luts = None
        self._digest_w = None

    def start(self, seq: SequenceHeader):
        """Begin a sequence: the window holds zero frames numbered 0."""
        self.seq = seq
        H, W = seq.height, seq.width
        if self.backend == "numpy":
            z = NpRefFrame(np.zeros((H, W), np.uint8),
                           np.zeros((H // 2, W // 2), np.uint8),
                           np.zeros((H // 2, W // 2), np.uint8), 0)
        else:
            z = RefFrame(*(torch.zeros((h + 2 * p, w + 2 * p),
                                       dtype=torch.uint8, device=self.device)
                           for h, w, p in ((H, W, PAD_Y),
                                           (H // 2, W // 2, PAD_C),
                                           (H // 2, W // 2, PAD_C))), 0)
        self.refs = [z] * MAX_REF_FRAMES
        self.interp_frame = None
        self.pending = []
        self.next_display = 0

    def interp_pair(self, fh):
        """interp_pair over the decoder's window."""
        return interp_pair(self.refs, fh)

    def _make_interp_frame(self, fh):
        """Synthesize the interpolated reference of frame `fh`. On the
        torch backend it is queued on the current stream (the host waits
        for nothing): with fused a replay of its signature's graph
        (ops/interp_fused.run_interp), else the stages one by one; on the
        numpy backend the C copy makes it on the host."""
        dfn = fh.display_frame_num
        if self.backend == "numpy":
            self.interp_frame = NpRefFrame(
                *temporal_interp.interpolate_frames(*self.interp_pair(fh)),
                dfn)
            return
        if self.fused:
            out = run_interp(self.device, *self.interp_pair(fh))
        else:
            out = interp.interpolate_frames(*self.interp_pair(fh))
        self.interp_frame = RefFrame(out[3], out[4], out[5], dfn)

    def _parse_python(self, payload, pos, nums):
        """FrameSyntax of one payload from the Python parser, counted into
        the statistics when they are collected."""
        br = BitReader(payload)
        br.pos = pos
        fs = FrameParser(self.seq, br, nums).parse()
        if self.stats is not None:
            count_frame(self.stats, fs, br.nbits)
        return fs

    def decode_stream(self, path: str, digest: bool = False):
        """Yield (y, u, v) uint8 numpy frames in display order; with
        digest=True (torch backend only) each frame's uint32 checksum
        instead, computed on the device (frame_digest_np's value)."""
        if digest and self.backend != "torch":
            raise ValueError("digest mode needs the torch backend")
        payloads = iter_frames(path)
        first = next(payloads, None)
        if first is None:
            return
        br = BitReader(first)
        self.start(SequenceHeader.read(br))
        if self.stats is not None:
            self.stats["seq_header"] = br.pos
        yield from self.decode_payloads(chain([first], payloads), br.pos,
                                        digest)

    def _pending_planes(self):
        """Unpadded planes of the snapshot's frames still to be output."""
        for r in self.pending:
            yield r.frame_num, tuple(
                p[n:-n, n:-n] for p, n in ((r.y, PAD_Y), (r.u, PAD_C),
                                           (r.v, PAD_C)))
        self.pending = []

    def decode_payloads(self, payloads, first_bit: int = 0,
                        digest: bool = False):
        """Decode frame payloads of the current sequence (the first one
        starting at bit `first_bit`) and yield display-order frames from
        `self.next_display` on."""
        if self.backend == "numpy":
            if digest:
                raise ValueError("digest mode needs the torch backend")
            yield from self._decode_payloads_np(payloads, first_bit)
        else:
            yield from self._decode_payloads_torch(payloads, first_bit,
                                                   digest)

    def _decode_payloads_np(self, payloads, first_bit):
        """thor_tpu's serial host loop (dec/decoder.py:176-219, :427-488)."""
        seq = self.seq
        W, H = seq.width, seq.height
        reorder = _Reorder(self.next_display)
        pos = first_bit
        try:
            for dfn, planes in self._pending_planes():
                yield from reorder.put(dfn, tuple(p.copy() for p in planes))
            for payload in payloads:
                nums = [r.frame_num for r in self.refs]
                if self.parse_mode == "native":
                    fs = native_parse_to_syntax(payload, pos, seq, nums)
                else:
                    fs = self._parse_python(payload, pos, nums)
                pos = 0
                if needs_interp(fs):
                    self._make_interp_frame(fs)
                y, u, v = reconstruct_frame_np(
                    fs, self.refs, self.interp_frame, W, H, seq.bipred,
                    seq.deblocking)
                apply_clpf(fs, y, u, v, W, H)
                dfn = fs.display_frame_num
                self.refs = [NpRefFrame(y, u, v, dfn)] + self.refs[:-1]
                yield from reorder.put(dfn, (y, u, v))
        finally:
            self.next_display = reorder.last + 1

    def _decode_payloads_torch(self, payloads, first_bit, digest):
        seq = self.seq
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        if self._luts is None:
            self._luts = mc_luts(seq.bipred, self.device)
        if digest and self._digest_w is None:
            n = seq.width * seq.height * 3 // 2
            self._digest_w = torch.arange(n, dtype=torch.int64,
                                          device=self.device) * 2 + 1
        out = (lambda planes: _Digest(planes, self._digest_w)) if digest \
            else _Output
        cs = seqhdr_from_python(seq)
        dev = self.device
        q: queue.Queue = queue.Queue(maxsize=_DEPTH + 2)
        stop = threading.Event()
        pool = ThreadPoolExecutor(max_workers=2)
        nums0 = [r.frame_num for r in self.refs]

        def parse(payload, pos, nums):
            if self.parse_mode == "native":
                return parse_frame(payload, pos, cs, nums)
            return syntax_to_native(self._parse_python(payload, pos, nums),
                                    seq)

        def build(nf, nums):
            cfg, inp, slots = build_frame_inputs(nf, seq, nums)
            clamped = inp.get("mc_clamped", 0)
            if self.fused:
                work = F.pack_frame(cfg, F.bucket_inputs(cfg, inp),
                                    seq.bipred, dev.type == "cuda")
            else:
                work = to_device(inp, dev)
            return cfg, work, slots, clamped

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.25)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                nums = list(nums0)
                pos = first_bit
                for payload in payloads:
                    nf = parse(payload, pos, nums)
                    pos = 0
                    fut = pool.submit(build, nf, list(nums))
                    if not put((nf.hdr, fut)):
                        return
                    nums = [nf.hdr.display_frame_num] + nums[:-1]
                put(None)
            except BaseException as e:           # noqa: BLE001
                put(e)                            # re-raised by the consumer

        reorder = _Reorder(self.next_display)
        ready: deque = deque()
        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            for dfn, planes in self._pending_planes():
                ready.extend(reorder.put(dfn, out(tuple(p.contiguous()
                                                        for p in planes))))
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                fh, fut = item
                if needs_interp(fh):
                    self._make_interp_frame(fh)
                cfg, work, slots, clamped = fut.result()
                if clamped:
                    self.mc_clamped += clamped
                    warnings.warn(
                        f"frame {fh.display_frame_num}: {clamped} MC windows "
                        "leave the padded reference and were clamped")
                refs = [self.refs[r] if r >= 0 else self.interp_frame
                        for r in slots]
                if self.fused:
                    planes, padded = F.run_frame(dev, work, refs)
                else:
                    planes, padded = reconstruct_frame(cfg, work, refs,
                                                       self._luts)
                dfn = fh.display_frame_num
                self.refs = [RefFrame(*padded, dfn)] + self.refs[:-1]
                ready.extend(reorder.put(dfn, out(planes)))
                while len(ready) > _DEPTH:
                    yield ready.popleft().get()
            while ready:
                yield ready.popleft().get()
        finally:
            self.next_display = reorder.last + 1
            stop.set()
            pool.shutdown(wait=True, cancel_futures=True)
            t.join()


def decode_file(path: str, out_path: Optional[str] = None, device=None,
                backend: str = "torch", parse: str = "native",
                fused: bool = True):
    """Decode a bitstream (backend "torch" on `device`, default "cuda";
    "numpy" on the host); write planar YUV to out_path, or return the list
    of (y, u, v) frames."""
    dec = Decoder(device=device, backend=backend, parse=parse, fused=fused)
    frames = []
    out = open(out_path, "wb") if out_path else None
    try:
        for (y, u, v) in dec.decode_stream(path):
            if out:
                out.write(y.tobytes())
                out.write(u.tobytes())
                out.write(v.tobytes())
            else:
                frames.append((y, u, v))
    finally:
        if out:
            out.close()
    return frames
