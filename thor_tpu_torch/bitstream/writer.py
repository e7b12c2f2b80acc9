"""Serial bitstream writer for the Thor VLC format.

Mirrors enc/putbits.c exactly: MSB-first 32-bit bit buffer flushed in
4-byte chunks, per-frame 4-byte big-endian length prefix, and stream
checkpoint/rewind (read/write_stream_pos, enc/putbits.c:136-146) - the
mechanism the RDO uses to trial-encode and retract. Host-side by design:
entropy emission is inherently serial and consumes precomputed
coefficient/mode tensors from the device stages. Counterpart of
thor_tpu/bitstream/writer.py.
"""

from __future__ import annotations

from ..codec.constants import log2i

MASK = [(1 << n) - 1 for n in range(33)]


class BitWriter:
    """Mirror of stream_t (enc/putbits.h:35-42)."""

    __slots__ = ("buf", "bitbuf", "bitrest")

    def __init__(self):
        self.buf = bytearray()
        self.bitbuf = 0          # 32-bit accumulator
        self.bitrest = 32        # free bits in accumulator

    def putbits(self, n: int, val: int) -> None:
        """enc/putbits.c:112-129"""
        if n <= self.bitrest:
            self.bitbuf |= (val & MASK[n]) << (self.bitrest - n)
            self.bitbuf &= 0xFFFFFFFF
            self.bitrest -= n
        else:
            rest = n - self.bitrest
            self.bitbuf |= (val >> rest) & MASK[n - rest]
            self.buf += self.bitbuf.to_bytes(4, "big")
            self.bitbuf = (val & MASK[rest]) << (32 - rest)
            self.bitbuf &= 0xFFFFFFFF
            self.bitrest = 32 - rest

    def get_bit_pos(self) -> int:
        return 8 * len(self.buf) + (32 - self.bitrest)

    # --- checkpoint / rewind (the RDO "what-if" mechanism) ---

    def save(self):
        return (len(self.buf), self.bitbuf, self.bitrest)

    def restore(self, pos) -> None:
        nbytes, bitbuf, bitrest = pos
        del self.buf[nbytes:]
        self.bitbuf = bitbuf
        self.bitrest = bitrest

    def flush_frame(self) -> bytes:
        """Close the current frame: returns the 4-byte BE length prefix +
        payload (enc/putbits.c:57-95) and resets the writer."""
        nbytes = 4 - self.bitrest // 8
        payload = bytes(self.buf) + self.bitbuf.to_bytes(4, "big")[:nbytes]
        out = len(payload).to_bytes(4, "big") + payload
        self.buf = bytearray()
        self.bitbuf = 0
        self.bitrest = 32
        return out


def put_vlc(n: int, cn: int, w: BitWriter) -> int:
    """VLC tables 0-13 (enc/putvlc.c:34-131). Returns the code length."""
    if n <= 5:
        if cn < 6 * (1 << n):
            tmp = 1 << n
            code = tmp + (cn & (tmp - 1))
            length = 1 + n + (cn >> n)
        else:
            code = cn - 6 * (1 << n) + (1 << n)
            length = (6 - n) + 1 + 2 * log2i(code)
    elif n <= 7:
        tmp = 1 << (n - 4)
        code = tmp + cn % tmp
        length = 1 + (n - 4) + (cn >> (n - 4))
    elif n == 8:
        if cn == 0:
            code, length = 1, 1
        elif cn == 1:
            code, length = 1, 2
        elif cn == 2:
            code, length = 0, 2
        else:
            raise ValueError("Code number too large for VLC8")
    elif n == 9:
        if cn == 0:
            code, length = 4, 3
        elif cn == 1:
            code, length = 10, 4
        elif cn == 2:
            code, length = 11, 4
        elif cn < 11:
            code, length = cn + 21, 5
        else:
            tmp = 1 << 4
            code = tmp + (cn + 5) % tmp
            length = 5 + ((cn + 5) >> 4)
    elif n == 10:
        code = cn + 1
        length = 1 + 2 * log2i(code)
    elif n == 11:
        length = cn + 1 if cn < 2 else cn // 2 + 3
        code = 1 if cn < 2 else 2 + (cn & 1)
    elif n == 12:
        length = min(4, cn + 1)
        code = int(cn != 4)
    elif n == 13:
        length = min(6, cn + 1)
        code = int(cn != 6)
    else:
        raise ValueError("No such VLC table, only 0-13 allowed")
    w.putbits(length, code)
    return length


def quote_vlc(n: int, cn: int) -> int:
    """Bit-count-only mirror of put_vlc (enc/putvlc.c:133-229)."""
    if n <= 5:
        if cn < 6 * (1 << n):
            return 1 + n + (cn >> n)
        code = cn - 6 * (1 << n) + (1 << n)
        return (6 - n) + 1 + 2 * log2i(code)
    if n <= 7:
        return 1 + (n - 4) + (cn >> (n - 4))
    if n == 8:
        return 1 if cn == 0 else 2
    if n == 9:
        if cn == 0:
            return 3
        if cn <= 2:
            return 4
        if cn < 11:
            return 5
        return 5 + ((cn + 5) >> 4)
    if n == 10:
        return 1 + 2 * log2i(cn + 1)
    if n == 11:
        return cn + 1 if cn < 2 else cn // 2 + 3
    if n == 12:
        return min(4, cn + 1)
    if n == 13:
        return min(6, cn + 1)
    raise ValueError("No such VLC table")
