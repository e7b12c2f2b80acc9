"""Frozen copy, for the benchmark's plain reference, of
thor_tpu_torch/bitstream/reader.py as of the benchmark's first version;
it imports nothing of the port, and the port's later changes do not
reach it.

Bit reader and stream framing for the Thor bitstream.

MSB-first bit order (dec/getbits.c); each frame is a 4-byte big-endian
length prefix followed by the payload, and reads past the payload return
zero bits (dec/getbits.c:98-102). The production entropy decode runs in
the native C layer (thor_tpu_torch.native); this reader parses the
sequence header and carries the VLC readers of the instrumented Python
parser (dec/parse.FrameParser), a copy of thor_tpu/bitstream/reader.py.
"""

from __future__ import annotations


class CorruptStream(Exception):
    """Raised on structurally impossible bitstream content (e.g. a
    truncated frame payload, or one decoding as a runaway VLC prefix)."""


class BitReader:
    """MSB-first bit reader over one frame payload."""

    __slots__ = ("data", "nbits", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.nbits = 8 * len(data)
        self.pos = 0  # absolute bit position

    def getbits(self, n: int) -> int:
        v = self.showbits(n)
        self.pos += n
        return v

    def getbits1(self) -> int:
        return self.getbits(1)

    def showbits(self, n: int) -> int:
        """Peek n bits; bits past end-of-payload read as 0."""
        v = 0
        pos = self.pos
        data = self.data
        nbits = self.nbits
        for _ in range(n):
            v <<= 1
            if pos < nbits:
                v |= (data[pos >> 3] >> (7 - (pos & 7))) & 1
            pos += 1
        return v

    def flushbits(self, n: int) -> None:
        self.pos += n

    @property
    def bitcnt(self) -> int:
        return self.pos


def get_vlc0_limit(maxbit: int, br: BitReader) -> int:
    """Bounded unary code (dec/getvlc.c:33-43)."""
    tmp = 0
    nbit = 0
    while tmp == 0 and nbit < maxbit:
        tmp = br.getbits1()
        nbit += 1
    return maxbit if tmp == 0 else nbit - 1


def get_vlc(n: int, br: BitReader) -> int:
    """VLC tables 0-13 (dec/getvlc.c:45-207)."""
    if n < 6:
        zeroes = 0
        done = False
        cw = 0
        while not done and zeroes < 6:
            if br.getbits1():
                cw = br.getbits(n)
                done = True
            else:
                zeroes += 1
        if done:
            return (zeroes << n) + cw
        # escape: growing suffix
        lead = n
        while True:
            if br.showbits(1) == 0:
                lead += 1
                br.flushbits(1)
                if lead > 32:
                    raise CorruptStream("vlc escape runaway prefix")
            else:
                tmp = br.getbits(lead + 1)
                return 6 * (1 << n) + tmp - (1 << n)
    elif n < 8:
        zeroes = 0
        while True:
            if br.getbits1():
                cw = br.getbits(n - 4)
                return (zeroes << (n - 4)) + cw
            zeroes += 1
            if zeroes > 64:
                raise CorruptStream("vlc6/7 runaway prefix")
    elif n == 8:
        if br.getbits1():
            return 0
        if br.getbits1():
            return 1
        return 2
    elif n == 9:
        if br.getbits1():
            if br.getbits1():
                return br.getbits(3) + 3
            if br.getbits1():
                return br.getbits1() + 1
            return 0
        zeroes = 0
        while True:
            if br.getbits1():
                cw = br.getbits(4)
                return (zeroes << 4) + cw + 11
            zeroes += 1
            if zeroes > 64:
                raise CorruptStream("vlc9 runaway prefix")
    elif n == 10:
        lead = 0
        while True:
            if br.showbits(1) == 0:
                lead += 1
                br.flushbits(1)
                if lead > 32:
                    raise CorruptStream("vlc10 runaway prefix")
            else:
                return br.getbits(lead + 1) - 1
    elif n == 11:
        if br.getbits(1):
            return 0
        if br.getbits(1):
            return 1
        val = 0
        while True:
            tmp = br.getbits(1)
            val += 2
            if tmp:
                break
            if val > 128:
                raise CorruptStream("vlc11 runaway prefix")
        return val + br.getbits(1)
    elif n == 12:
        val = 0
        while val < 4:
            if br.getbits(1):
                break
            val += 1
        return val
    elif n == 13:
        val = 0
        while val < 6:
            if br.getbits(1):
                break
            val += 1
        return val
    raise ValueError(f"illegal VLC table {n}")


def iter_frames(path: str):
    """Yield per-frame payload bytes from a Thor bitstream file.

    Framing: 4-byte big-endian frame length + payload
    (dec/getbits.c:48-69, enc/putbits.c:57-95).
    """
    with open(path, "rb") as f:
        while True:
            hdr = f.read(4)
            if len(hdr) < 4:
                return
            length = int.from_bytes(hdr, "big")
            payload = f.read(length)
            if len(payload) < length:
                raise CorruptStream(
                    f"truncated frame payload: expected {length} bytes, "
                    f"got {len(payload)}")
            yield payload
