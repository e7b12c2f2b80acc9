"""Thorenc-equivalent CLI (enc/mainenc.c:73-660, enc/strings.c).

Usage mirrors the reference, plus --device and --eager:
    python -m thor_tpu_torch.enc -if in.yuv -of out.bit \
        [-cf config.txt] [-rf rec.yuv] [-device_encode 0|1] \
        [-width W -height H -n N -qp QP ...] [--device cpu|cuda] [--eager]

-device_encode 0 (the default, as in python -m thor_tpu.enc) runs the host
mirror of the reference RD search: the block search in numpy on the host,
the in-loop filters, the reference window and the interpolated reference
on the device; it needs a width and a height that are multiples of 8.
-device_encode 1 runs the device encoder: I, P and B frames, all-intra
(-intra_period 1), low-delay (LDB: -max_num_ref, -enable_bipred) and
random-access configurations (-num_reorder_pics, -interp_ref), at sizes
that are multiples of 8 and hold a 64x64 superblock.

Flag precedence: defaults -> config file(s) -> command line
(enc/strings.c:340-356). Encodes on the card by default; --device cpu
runs the kernels' plain PyTorch versions on the CPU. The device encoder's
P and B frames run as the programs of enc/fused.py (one CUDA graph each
per signature on a card); --eager runs their stages one by one
(Encoder(fused=False)).
"""

from __future__ import annotations

import sys
import time

import numpy as np

from .encoder import (FLOAT_PARAMS, Encoder, EncoderParams, apply_args,
                      read_yuv_frames)
from ..utils.snr import snr_yuv


def parse_args(argv):
    """Defaults -> config file(s) -> command line, with the reference
    parse_params semantics incl. recursive -cf and fatal unknown flags
    (enc/strings.c:137-265, 340-356). Returns (params, files, device)."""
    argv = list(argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 >= len(argv):
            raise ValueError("No value found for parameter: --device")
        device = argv[i + 1]
        del argv[i:i + 2]
    params = EncoderParams()
    files = {"if": None, "of": None, "rf": None, "stat": None}
    apply_args(argv, params, files)
    # float32 semantics (see EncoderParams.from_config_file)
    for f_ in FLOAT_PARAMS:
        setattr(params, f_, float(np.float32(getattr(params, f_))))
    return params, files, device


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    eager = "--eager" in argv
    argv = [a for a in argv if a != "--eager"]
    try:
        params, files, device = parse_args(argv)
    except ValueError as e:
        print(e, file=sys.stderr)
        return 1
    if not files["if"] or not files["of"]:
        print("need -if <input.yuv> and -of <output.bit>", file=sys.stderr)
        return 1

    # y4m input auto-detect (enc/strings.c:359-409)
    from ..utils.y4m import probe_y4m, read_y4m_frames, Y4MWriter
    y4m = probe_y4m(files["if"])
    if y4m is not None:
        params.width, params.height, params.frame_rate = \
            y4m[0], y4m[1], float(y4m[2])
        frames = list(read_y4m_frames(files["if"]))
    else:
        frames = list(read_yuv_frames(files["if"], params.width,
                                      params.height))

    enc = Encoder(params, device=device, fused=not eager)
    t0 = time.time()
    recons = enc.encode_sequence(frames, files["of"])
    dt = time.time() - t0

    if files["rf"]:
        if files["rf"].endswith(".y4m"):
            wtr = Y4MWriter(files["rf"], params.width, params.height,
                            params.frame_rate)
            for (y, u, v) in recons:
                wtr.write(y, u, v)
            wtr.close()
        else:
            with open(files["rf"], "wb") as f:
                for (y, u, v) in recons:
                    f.write(y.tobytes() + u.tobytes() + v.tobytes())

    import os
    nbits = os.path.getsize(files["of"]) * 8
    n = len(recons)
    kbps = 0.001 * params.frame_rate * nbits / max(n, 1)
    acc = [0.0, 0.0, 0.0]
    if params.snrcalc:
        for i, rec in enumerate(recons):
            p = snr_yuv(frames[params.skip + i], rec)
            for k in range(3):
                acc[k] += p[k]
    print("------------------- Average data for all frames "
          "------------------------------")
    print(f"kbps            : {kbps:12.3f}")
    print(f"PSNR Y          : {acc[0]/max(n,1):12.3f}")
    print(f"PSNR U          : {acc[1]/max(n,1):12.3f}")
    print(f"PSNR V          : {acc[2]/max(n,1):12.3f}")
    print(f"frames/s encode : {n/dt:12.3f}")
    print("---------------------------------------------------------"
          "---------------------")
    if files["stat"]:
        import os.path as osp
        new = not osp.exists(files["stat"])
        with open(files["stat"], "a") as f:
            if new:
                f.write(" NFR     kbps     PSNRY  PSNRU  PSNRV\n")
            f.write(f"{params.num_frames:4d} {kbps:12.3f} "
                    f"{acc[0]/max(n,1):6.3f} {acc[1]/max(n,1):6.3f} "
                    f"{acc[2]/max(n,1):6.3f}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
