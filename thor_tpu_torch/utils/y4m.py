"""YUV4MPEG2 (y4m) container support (enc/strings.c:359-409 auto-detect,
enc/mainenc.c:140-146 y4m reconstruction output)."""

from __future__ import annotations

import numpy as np


def probe_y4m(path: str):
    """If `path` is a y4m file, return (width, height, frame_rate,
    header_len, frame_header_len); else None."""
    with open(path, "rb") as f:
        buf = f.read(256)
    if not buf.startswith(b"YUV4MPEG2 "):
        return None
    nl = buf.index(b"\n")
    header = buf[:nl].decode("ascii", "replace")
    width = height = 0
    frame_rate = 30.0
    for tok in header.split()[1:]:
        if tok.startswith("W"):
            width = int(tok[1:])
        elif tok.startswith("H"):
            height = int(tok[1:])
        elif tok.startswith("F"):
            den, num = tok[1:].split(":")
            frame_rate = float(den) / float(num)
        elif tok.startswith("I") and tok[1:2] != "p":
            raise ValueError("only progressive y4m input supported")
    if not buf[nl:nl + 7] == b"\nFRAME\n" and b"FRAME" not in buf[nl:nl+32]:
        raise ValueError("corrupt y4m file")
    return width, height, frame_rate, nl + 1, 6


def read_y4m_frames(path: str, num_frames=None):
    """Yield (y, u, v) planes from a y4m file."""
    width, height, _fps, hdr, _fh = probe_y4m(path)
    ysz, csz = width * height, (width // 2) * (height // 2)
    with open(path, "rb") as f:
        f.seek(hdr)
        n = 0
        while num_frames is None or n < num_frames:
            line = f.readline()
            if not line or not line.startswith(b"FRAME"):
                return
            buf = f.read(ysz + 2 * csz)
            if len(buf) < ysz + 2 * csz:
                return
            y = np.frombuffer(buf, np.uint8, ysz).reshape(height, width)
            u = np.frombuffer(buf, np.uint8, csz, ysz).reshape(
                height // 2, width // 2)
            v = np.frombuffer(buf, np.uint8, csz, ysz + csz).reshape(
                height // 2, width // 2)
            yield y.copy(), u.copy(), v.copy()
            n += 1


class Y4MWriter:
    def __init__(self, path: str, width: int, height: int,
                 frame_rate: float = 60.0):
        self.f = open(path, "wb")
        self.f.write(
            f"YUV4MPEG2 W{width} H{height} F{int(frame_rate)}:1 Ip A0:0 "
            f"C420jpeg XYSCSS=420JPEG\x0a".encode())

    def write(self, y, u, v):
        self.f.write(b"FRAME\x0a")
        self.f.write(y.tobytes() + u.tobytes() + v.tobytes())

    def close(self):
        self.f.close()
