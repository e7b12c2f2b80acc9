"""Top-level decoder: stream framing, the sliding reference window,
reorder to display order (dec/maindec.c:91-195, dec/decode_frame.c:45-148).

Pipelined like thor_tpu dec/decoder.py:222-356:
  - a parse thread runs the serial C entropy parse, tracking the window
    of reference display numbers itself;
  - a small worker pool builds each parsed frame's inputs and copies them
    to the device ahead of time;
  - the main thread stacks the reference planes, queues the frame
    program, and materializes output _DEPTH frames behind the dispatch
    front (each frame's device->host copy is queued right after its
    program, into pinned memory, and waited for only when yielded).
The reference window (33 frames, codec-padded) stays on the device, and so
does the interpolated reference of RA / HDB streams: it is synthesized
from two window frames (ops/interp.py) on the same stream, just before
the frame program that predicts from it.
"""

from __future__ import annotations

import queue
import threading
import warnings
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from itertools import chain
from typing import Optional

import torch

from ..bitstream.reader import BitReader, iter_frames
from ..codec.constants import (
    MAX_REF_FRAMES, MAX_REORDER_BUFFER, PAD_C, PAD_Y)
from ..device import resolve_device
from ..native import parse_frame, seqhdr_from_python
from ..ops.interp import interpolate_frames
from .inputs import build_frame_inputs
from .parse import SequenceHeader
from .reconstruct import mc_luts, reconstruct_frame, to_device

_DEPTH = 2      # frames in flight between dispatch and output


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


class Decoder:
    """Decodes Thor streams on `device` ("cuda" by default; "cpu" runs
    the kernels' plain versions). `mc_clamped` counts the MC cell windows
    that left the padded reference plane and were clamped into it
    (ops/mc.py:build_mc_records); a valid stream has none. `interp_frame`
    is the newest interpolated reference (padded planes on the device,
    numbered as the frame it was made for), or None. `pending` lists
    window frames a loaded snapshot had decoded but not yet output; the
    next decode_payloads call puts them out in their display order."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.seq: Optional[SequenceHeader] = None
        self.refs = [None] * MAX_REF_FRAMES
        self.interp_frame = None
        self.pending = []
        self.next_display = 0
        self.mc_clamped = 0
        self._luts = None

    def start(self, seq: SequenceHeader):
        """Begin a sequence: the window holds zero frames numbered 0."""
        self.seq = seq
        H, W = seq.height, seq.width
        z = RefFrame(*(torch.zeros((h + 2 * p, w + 2 * p), dtype=torch.uint8,
                                   device=self.device)
                       for h, w, p in ((H, W, PAD_Y), (H // 2, W // 2, PAD_C),
                                       (H // 2, W // 2, PAD_C))), 0)
        self.refs = [z] * MAX_REF_FRAMES
        self.interp_frame = None
        self.pending = []
        self.next_display = 0

    def interp_pair(self, fh):
        """(r1, r2, ratio, pos): the two window frames that frame `fh`'s
        interpolated reference is made from and where it lies between
        them (dec/decode_frame.c:91-109)."""
        dfn = fh.display_frame_num
        r1 = self.refs[fh.ref_array[1]]
        r2 = self.refs[fh.ref_array[2]]
        off1 = r2.frame_num - dfn
        off2 = dfn - r1.frame_num
        if off1 < 0 and off2 < 0:
            off1, off2 = -off1, -off2
        if off1 == off2:
            off1 = off2 = 1
        return r1, r2, off1 + off2, off2

    def _make_interp_frame(self, fh):
        """Synthesize the interpolated reference of frame `fh`. Queued on
        the current stream; the host waits for nothing."""
        out = interpolate_frames(*self.interp_pair(fh))
        self.interp_frame = RefFrame(out[3], out[4], out[5],
                                     fh.display_frame_num)

    def decode_stream(self, path: str):
        """Yield (y, u, v) uint8 numpy frames in display order."""
        payloads = iter_frames(path)
        first = next(payloads, None)
        if first is None:
            return
        br = BitReader(first)
        self.start(SequenceHeader.read(br))
        yield from self.decode_payloads(chain([first], payloads), br.pos)

    def decode_payloads(self, payloads, first_bit: int = 0):
        """Decode frame payloads of the current sequence (the first one
        starting at bit `first_bit`) and yield display-order frames from
        `self.next_display` on."""
        seq = self.seq
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        if self._luts is None:
            self._luts = mc_luts(seq.bipred, self.device)
        cs = seqhdr_from_python(seq)
        dev = self.device
        q: queue.Queue = queue.Queue(maxsize=_DEPTH + 2)
        stop = threading.Event()
        pool = ThreadPoolExecutor(max_workers=2)
        nums0 = [r.frame_num for r in self.refs]

        def build(nf, nums):
            cfg, inp, slots = build_frame_inputs(nf, seq, nums)
            return cfg, to_device(inp, dev), slots

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
                    nf = parse_frame(payload, pos, cs, nums)
                    pos = 0
                    fut = pool.submit(build, nf, list(nums))
                    if not put((nf.hdr, fut)):
                        return
                    nums = [nf.hdr.display_frame_num] + nums[:-1]
                put(None)
            except BaseException as e:           # noqa: BLE001
                put(e)                            # re-raised by the consumer

        reorder: dict = {}
        for r in self.pending:
            reorder[r.frame_num % MAX_REORDER_BUFFER] = _Output(tuple(
                p[n:-n, n:-n].contiguous()
                for p, n in ((r.y, PAD_Y), (r.u, PAD_C), (r.v, PAD_C))))
        self.pending = []
        t = threading.Thread(target=producer, daemon=True)
        t.start()
        last_output = self.next_display - 1
        ready: deque = deque()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                fh, fut = item
                if needs_interp(fh):
                    self._make_interp_frame(fh)
                cfg, inp, slots = fut.result()
                clamped = inp.get("mc_clamped", 0)
                if clamped:
                    self.mc_clamped += clamped
                    warnings.warn(
                        f"frame {fh.display_frame_num}: {clamped} MC windows "
                        "leave the padded reference and were clamped")
                refs = [self.refs[r] if r >= 0 else self.interp_frame
                        for r in slots]
                planes, padded = reconstruct_frame(cfg, inp, refs,
                                                   self._luts)
                dfn = fh.display_frame_num
                self.refs = [RefFrame(*padded, dfn)] + self.refs[:-1]
                reorder[dfn % MAX_REORDER_BUFFER] = _Output(planes)
                while (last_output + 1) % MAX_REORDER_BUFFER in reorder:
                    last_output += 1
                    ready.append(reorder.pop(last_output % MAX_REORDER_BUFFER))
                while len(ready) > _DEPTH:
                    yield ready.popleft().get()
            while ready:
                yield ready.popleft().get()
        finally:
            self.next_display = last_output + 1
            stop.set()
            pool.shutdown(wait=True, cancel_futures=True)
            t.join()


def decode_file(path: str, out_path: Optional[str] = None, device=None):
    """Decode a bitstream on `device` (default "cuda"); write planar YUV
    to out_path, or return the list of (y, u, v) frames."""
    dec = Decoder(device=device)
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
