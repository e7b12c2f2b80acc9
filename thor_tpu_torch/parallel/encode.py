"""GOP-parallel encode over slots (CUDA streams and cards).

Counterpart of thor_tpu/parallel/encode.py: the sequence loop
(enc/mainenc.c:222-580, single-threaded in the reference) with the frames
of a dyadic B level in flight at once. Within a sub-GOP the B levels are
2-8 frames wide, and frames of one level are independent given their
references (enc/mainenc.c:48-71 defines the coding order), so each
level's frames are measured concurrently, one frame per slot, queued
back to back, and drained in coding order. The stream is assembled in
coding order, byte-identical to the sequential Encoder.encode_sequence.

Each clone encodes under its slot's card and stream (parallel/mesh.py
rule (b)), where thor_tpu uses jax.default_device. A reference made on
another slot is handed over by parallel/mesh.Made (rules (a), (d)): an
event wait and record_stream on the same card, a copy to another card.
The interpolated reference of a B frame is synthesized by ops/interp on
the clone's slot once both its references are made (thor_tpu uses its
host C twin in a one-worker pool). The host mirror (device_encode=0)
codes a frame whole in encode_frame_begin and is drained at once; since
it keeps state across frames (its ME candidates and its reconstruction
buffer), its frames run one at a time on the master's mirror.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..bitstream.writer import BitWriter
from ..codec.blockdata import DeblockData
from ..codec.constants import B_FRAME, MAX_REORDER_BUFFER
from ..device import resolve_device
from ..enc.encoder import (Encoder, EncoderParams, RefFrame,
                           _reorder_frame_offset, _log2i)
from ..ops.interp import interpolate_frames
from .mesh import Made, Slot


class _PendingRef(RefFrame):
    """Sliding-window placeholder for a frame planned but not yet
    reconstructed. Carries the frame number (all the planner reads);
    fill() turns it into the finished frame's padded reference in place,
    so clones holding it see the planes the moment the producing frame
    drains."""

    def __init__(self, frame_num):
        self.frame_num = frame_num
        self.y = self.u = self.v = None
        self._host = None
        self.made = None

    @property
    def filled(self):
        return self.y is not None

    def fill(self, ref: RefFrame, slot: Slot):
        """Take the padded planes (and host copy) of `ref`, which
        encode_frame_finish made on `slot`."""
        self.y, self.u, self.v, self._host = ref.y, ref.u, ref.v, ref._host
        with slot.active():
            self.made = Made((ref.y, ref.u, ref.v), slot)

    def on(self, slot: Slot) -> RefFrame:
        """This reference as a clone on `slot` may read it: itself on the
        producer's card (after the stream handover), else a copy."""
        planes = self.made.on(slot)
        if planes[0] is self.y:
            return self
        return RefFrame.of_padded(*planes, self.frame_num, host=self._host)


class ShardedEncoder:
    """Encode a sequence with dependency-level frames in flight
    concurrently, one per slot: `devices` lists a device per slot (one
    card twice: two streams on it); every visible card by default.
    Byte-identical to the sequential encoder."""

    def __init__(self, params: EncoderParams, devices=None):
        if devices is None:
            dev = resolve_device("cuda")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())] \
                if dev.type == "cuda" else [dev]
        self.slots = [Slot(resolve_device(d)) for d in devices]
        self.params = params
        self.enc = Encoder(params, device=self.slots[0].device)
        self.enc._defer_interp = True

    # -- one planned frame ------------------------------------------------

    def _plan_frame(self, frames, frame_num, num_encoded, sub_gop,
                    min_interp_depth, last_PorI):
        """Run the master's schedule arithmetic for one frame and
        snapshot an independent frame-encoder clone."""
        enc = self.enc
        enc.frame_num = frame_num - self.params.skip
        enc._pending_interp = None
        enc._setup_frame(num_encoded, sub_gop, min_interp_depth,
                         last_PorI)
        fe = copy.copy(enc)
        fe.refs = list(enc.refs)
        fe.ref_array = list(enc.ref_array)
        fe.deblock_data = DeblockData(enc.width, enc.height)
        fe.frame_times = []
        fe._defer_interp = False
        fe.org_frame = frames[frame_num]
        pend = enc._pending_interp
        # master window gains a placeholder the drain fills in coding
        # order (twin of encode_frame_finish's sliding-window update)
        enc.refs = [_PendingRef(enc.frame_num)] + enc.refs[:-1]
        return fe, pend

    @staticmethod
    def _deps_ready(fe, pend):
        """True when no resolved reference of this frame is an
        unfilled placeholder (same-level dependency)."""
        for r in fe.ref_array:
            if r >= 0:
                ref = fe.refs[r]
                if isinstance(ref, _PendingRef) and not ref.filled:
                    return False
        if pend is not None:
            for ref in pend[:2]:
                if isinstance(ref, _PendingRef) and not ref.filled:
                    return False
        return True

    def _begin(self, fe, pend, slot, w):
        """Hand the clone its references on `slot`, synthesize its
        interpolated reference there, upload the frame and run the
        measurement half (the whole encode of an I or mirror frame)."""
        fe.device = slot.device
        with slot.active():
            reads = [fe.refs[r] for r in fe.ref_array if r >= 0] \
                + (list(pend[:2]) if pend is not None else [])
            local = {id(r): r.on(slot) for r in reads
                     if isinstance(r, _PendingRef)}
            fe.refs = [local.get(id(r), r) for r in fe.refs]
            if pend is not None:
                r1, r2, ratio, pos = pend
                out = interpolate_frames(local[id(r1)], local[id(r2)],
                                         ratio, pos)
                fe.interp_frame = RefFrame.of_padded(out[3], out[4], out[5],
                                                     fe.frame_num)
                if not self.params.device_encode:
                    fe.interp_frame.host()
            fe.org_y, fe.org_u, fe.org_v = (
                torch.from_numpy(np.ascontiguousarray(a)).to(slot.device)
                for a in fe.org_frame)
            return fe.encode_frame_begin(w)

    # -- sequence loop ----------------------------------------------------

    def encode_sequence(self, frames, out_path: str):
        """Mirror of Encoder.encode_sequence with level-concurrent
        staged measurement (no checkpoint/resume). Returns the
        reconstructed frames in display order, as numpy planes; the
        master's frame_times holds every frame's stage times in coding
        order."""
        p = self.params
        enc = self.enc
        frames = list(frames)
        input_total = len(frames)
        w0 = BitWriter()
        mirror = not p.device_encode

        # Sequence header (enc/mainenc.c:195-212)
        w0.putbits(16, enc.width)
        w0.putbits(16, enc.height)
        w0.putbits(1, p.enable_pb_split)
        w0.putbits(1, p.enable_tb_split)
        w0.putbits(2, p.max_num_ref - 1)
        w0.putbits(1, p.interp_ref)
        w0.putbits(3, p.max_delta_qp)
        w0.putbits(1, p.deblocking)
        w0.putbits(1, p.clpf)
        w0.putbits(1, p.use_block_contexts)
        w0.putbits(1, p.enable_bipred)

        sub_gop = max(1, p.num_reorder_pics + 1)
        min_interp_depth = _log2i(p.num_reorder_pics + 1) - 2
        if p.frame_rate > 30:
            min_interp_depth -= 1

        num_encoded = 0
        last_PorI = -1
        enc.last_intra_frame_num = 0
        frame_num0 = p.skip

        rec_avail = {}
        last_output = -1
        display = []
        batch = []   # staged (fe, w, ctx, slot) awaiting drain
        first_frame = True

        with open(out_path, "wb") as out:

            def drain_one():
                """Finish the OLDEST in-flight frame only: a frame whose
                dependencies are already filled never waits for the rest
                of the batch."""
                nonlocal last_output
                (fe, w, ctx, slot) = batch.pop(0)
                with slot.active():
                    fe.encode_frame_finish(w, ctx)
                    rec = tuple(t.cpu().numpy()
                                for t in (fe.rec_y, fe.rec_u, fe.rec_v))
                out.write(w.flush_frame())
                enc.frame_times.extend(fe.frame_times)
                # the mirror's next frame starts from this reconstruction
                enc.rec_y, enc.rec_u, enc.rec_v = fe.rec_y, fe.rec_u, fe.rec_v
                # master window: fill this frame's placeholder
                for ref in enc.refs:
                    if isinstance(ref, _PendingRef) \
                            and ref.frame_num == fe.frame_num \
                            and not ref.filled:
                        ref.fill(fe.refs[0], slot)
                        break
                rec_avail[fe.frame_num % MAX_REORDER_BUFFER] = rec
                nxt = (last_output + 1) % MAX_REORDER_BUFFER
                if nxt in rec_avail:
                    last_output += 1
                    display.append(rec_avail.pop(nxt))

            def drain():
                while batch:
                    drain_one()

            while (frame_num0 < p.skip + p.num_frames
                   and frame_num0 + 1 <= input_total):
                plans = []
                for k in range(sub_gop):
                    offset = _reorder_frame_offset(k, sub_gop,
                                                   p.dyadic_coding)
                    frame_num = frame_num0 + offset
                    if frame_num < p.skip:
                        continue
                    fe, pend = self._plan_frame(frames, frame_num,
                                                num_encoded, sub_gop,
                                                min_interp_depth, last_PorI)
                    num_encoded += 1
                    last_PorI = 0 if fe.frame_type != B_FRAME \
                        else last_PorI + 1
                    plans.append((fe, pend))

                for fe, pend in plans:
                    while not self._deps_ready(fe, pend) \
                            or len(batch) >= len(self.slots):
                        drain_one()
                    if mirror:
                        # one mirror frame at a time, on the master's
                        # mirror, from the last frame's reconstruction
                        drain()
                        fe.rec_y, fe.rec_u, fe.rec_v = \
                            enc.rec_y, enc.rec_u, enc.rec_v
                        enc.mirror.enc = fe
                    slot = self.slots[len(batch) % len(self.slots)]
                    w = w0 if first_frame else BitWriter()
                    first_frame = False
                    ctx = self._begin(fe, pend, slot, w)
                    batch.append((fe, w, ctx, slot))
                    if ctx is None:
                        # intra / mirror frame encoded fully in begin;
                        # drain so the next frame sees its reconstruction
                        drain()
                drain()
                # Revert to PPP when the sub-GOP no longer fits
                # (enc/mainenc.c:586-590)
                if ((frame_num0 + sub_gop + 1 > input_total
                     or frame_num0 + sub_gop >= p.skip + p.num_frames)
                        and sub_gop >= 2):
                    p.HQperiod = sub_gop
                    sub_gop = 1
                    p.num_reorder_pics = 0
                frame_num0 += sub_gop
            drain()
        enc.mirror.enc = enc
        for i in range(1, MAX_REORDER_BUFFER + 1):
            nxt = (last_output + i) % MAX_REORDER_BUFFER
            if nxt in rec_avail:
                display.append(rec_avail.pop(nxt))
            else:
                break
        return display
