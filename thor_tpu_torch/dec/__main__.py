"""Thordec-equivalent CLI.

Usage: python -m thor_tpu_torch.dec in.bit out.yuv [--device cpu|cuda]

Decodes on the card by default; --device cpu runs the kernels' plain
PyTorch versions on the CPU.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m thor_tpu_torch.dec")
    ap.add_argument("bitstream")
    ap.add_argument("output")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from .decoder import Decoder

    dec = Decoder(device=args.device)
    n = 0
    t0 = time.perf_counter()
    with open(args.output, "wb") as out:
        for (y, u, v) in dec.decode_stream(args.bitstream):
            out.write(y.tobytes() + u.tobytes() + v.tobytes())
            n += 1
    dt = time.perf_counter() - t0
    print(f"decoded {n} frames in {dt:.2f}s ({n / dt:.2f} frames/s, "
          f"device={dec.device})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
