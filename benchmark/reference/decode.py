"""The benchmark's plain reference decoder and its counts of a stream's
syntax.

decode() is the serial host loop of thor_tpu_torch's numpy backend
(dec/decoder.py: Decoder.decode_stream, _decode_payloads_np, _Reorder,
needs_interp), frozen here with the parse and the numpy reconstruction
beside it. It imports nothing of the port. It decodes no frame that
predicts from a temporally interpolated reference (random-access
streams; the encode cells write none): such a frame is one it cannot
decode. syntax_counts() reads the same parse for the work the roofline
readers count (work.py): the intra transform units of each frame by
plane class and size.
"""

from __future__ import annotations

from collections import Counter
from itertools import chain

import numpy as np

from .constants import MAX_REF_FRAMES, MAX_REORDER_BUFFER, MODE_INTRA
from .parse import FrameParser, SequenceHeader
from .reader import BitReader, CorruptStream, iter_frames
from .reconstruct_np import RefFrame, apply_clpf, reconstruct_frame


def needs_interp(fs) -> bool:
    """The frame predicts from a temporally interpolated reference
    (dec/decode_frame.c:91-109)."""
    return bool(fs.interp_ref_frame and fs.num_ref > 2
                and fs.ref_array[0] == -1)


def _parsed(payloads):
    """(sequence header, FrameSyntax of each payload in coding order)."""
    payloads = iter(payloads)
    first = next(payloads)
    br = BitReader(first)
    seq = SequenceHeader.read(br)
    nums = [0] * MAX_REF_FRAMES
    for i, payload in enumerate(chain([first], payloads)):
        r = BitReader(payload)
        r.pos = br.pos if i == 0 else 0
        fs = FrameParser(seq, r, list(nums)).parse()
        nums = [fs.display_frame_num] + nums[:-1]
        yield seq, fs


def payloads_of(stream) -> list:
    """The frame payloads of a stream file (a path) or of its bytes."""
    if isinstance(stream, (bytes, bytearray)):
        out, pos = [], 0
        while pos + 4 <= len(stream):
            n = int.from_bytes(stream[pos:pos + 4], "big")
            out.append(bytes(stream[pos + 4:pos + 4 + n]))
            pos += 4 + n
        return out
    return list(iter_frames(str(stream)))


def decode(stream) -> list:
    """The (y, u, v) uint8 frames of a stream (a path or its bytes), in
    display order."""
    refs, done, out = None, {}, []
    for seq, fs in _parsed(payloads_of(stream)):
        W, H = seq.width, seq.height
        if refs is None:
            z = RefFrame(np.zeros((H, W), np.uint8),
                         np.zeros((H // 2, W // 2), np.uint8),
                         np.zeros((H // 2, W // 2), np.uint8), 0)
            refs = [z] * MAX_REF_FRAMES
        if needs_interp(fs):
            raise CorruptStream("an interpolated reference")
        y, u, v = reconstruct_frame(fs, refs, None, W, H, seq.bipred,
                                    seq.deblocking)
        apply_clpf(fs, y, u, v, W, H)
        refs = [RefFrame(y, u, v, fs.display_frame_num)] + refs[:-1]
        done[fs.display_frame_num % MAX_REORDER_BUFFER] = (y, u, v)
        while len(out) % MAX_REORDER_BUFFER in done:
            out.append(done.pop(len(out) % MAX_REORDER_BUFFER))
    return out


def read_frame_header(payload: bytes, pos: int) -> tuple:
    """(frame type, frame qp, reference slots, display number) of a frame
    header (FrameParser.parse's first reads, dec/decode_frame.c:58-90)."""
    br = BitReader(payload)
    br.pos = pos
    frame_type = br.getbits(1)
    qp = br.getbits(8)
    br.getbits(4)
    refs = []
    if frame_type != 0:
        num_ref = br.getbits(2) + 1
        refs = [br.getbits(6) - 1 for _ in range(num_ref)]
        if num_ref == 2 and refs[0] == -1:
            refs.append(br.getbits(5) - 1)
    return frame_type, qp, refs, br.getbits(16)


def stream_headers(stream) -> tuple:
    """(SequenceHeader, [[frame type, frame qp, reference slots]] in coding
    order) of a stream (a path or its bytes), from the headers alone."""
    payloads = payloads_of(stream)
    br = BitReader(payloads[0])
    seq = SequenceHeader.read(br)
    frames = [list(read_frame_header(p, br.pos if k == 0 else 0)[:3])
              for k, p in enumerate(payloads)]
    return seq, frames


def frame_tasks(stream: bytes, frames):
    """One task per frame of a stream for check_frame: the frame's
    payload, the display numbers of the reference window as it stands
    when the frame is decoded, the planes of the window slots the frame's
    header names, taken from `frames` (a decoder's frames of the same
    stream, in display order), and the frame that decoder gave for it."""
    payloads = payloads_of(stream)
    br = BitReader(payloads[0])
    seq = SequenceHeader.read(br)
    W, H = seq.width, seq.height
    zero = (np.zeros((H, W), np.uint8), np.zeros((H // 2, W // 2), np.uint8),
            np.zeros((H // 2, W // 2), np.uint8))
    order = []                      # display numbers in coding order
    tasks = []
    for k, payload in enumerate(payloads):
        pos = br.pos if k == 0 else 0
        *_, slots, dfn = read_frame_header(payload, pos)
        nums = [order[k - 1 - r] if r < k else 0
                for r in range(MAX_REF_FRAMES)]
        window = {r: frames[nums[r]] if r < k and nums[r] < len(frames)
                  else zero for r in slots if r >= 0}
        got = frames[dfn] if dfn < len(frames) else None
        tasks.append((seq, payload, pos, nums, window, got))
        order.append(dfn)
    return tasks


def check_frame(task) -> tuple:
    """(samples that differ, samples compared) of one frame_tasks task:
    the plain reference decodes the frame's payload over the given
    reference window and compares its frame with the decoder's. A
    payload the reference cannot decode differs in every sample."""
    seq, payload, pos, nums, window, got = task
    W, H = seq.width, seq.height
    n = W * H * 3 // 2
    try:
        br = BitReader(payload)
        br.pos = pos
        fs = FrameParser(seq, br, list(nums)).parse()
        refs = [None] * MAX_REF_FRAMES
        for r, planes in window.items():
            refs[r] = RefFrame(*planes, nums[r])
        if needs_interp(fs):
            raise CorruptStream("an interpolated reference")
        y, u, v = reconstruct_frame(fs, refs, None, W, H, seq.bipred,
                                    seq.deblocking)
        apply_clpf(fs, y, u, v, W, H)
    except (CorruptStream, IndexError, KeyError, ValueError):
        return n, n         # a payload the reference cannot decode
    if got is None:
        return n, n
    return sum(int(np.count_nonzero(a != b)) if a.shape == b.shape
               else a.size for a, b in zip((y, u, v), got)), n


def _tus(b, plane: str):
    """(size, coefficients) of each transform unit of intra block b in
    plane "y", "u" or "v" (dec/decode_block.c:48-88)."""
    size = b.size if plane == "y" else b.size // 2
    coeff = getattr(b, "coeff_" + plane)
    split = b.tb_split and (plane == "y" or size > 4)
    if not split:
        return [(size, coeff)]
    s2 = size // 2
    return [(s2, None if coeff is None else coeff[i:i + s2, j:j + s2])
            for i in (0, s2) for j in (0, s2)]


def syntax_counts(stream) -> list:
    """Per frame in coding order: {"width", "height", "intra": Counter of
    (plane class "Y" | "UV", TU size, coded) -> TUs}, where coded says
    whether the TU has a nonzero coefficient."""
    frames = []
    for seq, fs in _parsed(payloads_of(stream)):
        c = Counter()
        for b in fs.blocks:
            if b.mode != MODE_INTRA:
                continue
            for plane in ("y", "u", "v"):
                for s, co in _tus(b, plane):
                    coded = co is not None and bool(np.any(co))
                    c[("Y" if plane == "y" else "UV", s, coded)] += 1
        frames.append({"width": seq.width, "height": seq.height,
                       "intra": c})
    return frames
