"""Bit reader and stream framing for the Thor bitstream.

MSB-first bit order (dec/getbits.c); each frame is a 4-byte big-endian
length prefix followed by the payload, and reads past the payload return
zero bits (dec/getbits.c:98-102). The entropy decode itself runs in the
native C layer (thor_tpu_torch.native); this reader only parses the
sequence header.
"""

from __future__ import annotations


class CorruptStream(Exception):
    """Raised on structurally impossible bitstream content (e.g. a
    truncated frame payload)."""


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

    def showbits(self, n: int) -> int:
        """Peek n bits; bits past end-of-payload read as 0."""
        v = 0
        pos = self.pos
        for _ in range(n):
            v <<= 1
            if pos < self.nbits:
                v |= (self.data[pos >> 3] >> (7 - (pos & 7))) & 1
            pos += 1
        return v


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
