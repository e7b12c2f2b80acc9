#!/usr/bin/env python3
"""Write the encoder goldens of the PyTorch/CUDA port.

    JAX_PLATFORMS=cpu python3 tools/gen_torch_enc_goldens.py [case ...]

The port's device encoder (thor_tpu_torch.enc) must write the same bytes
as thor_tpu's (device_encode=1) for the same EncoderParams and input. A
machine with a CUDA card has no JAX, so the oracle's streams are kept as
data: this tool runs thor_tpu's encoder on crops of the committed
testdata/test_cif.yuv and writes testdata/torch_enc_<case>.bit for every
case of CASES (or the named ones), after checking that thor_tpu's numpy
decoder reproduces the encoder's reconstruction. XLA compiles dominate
its run time on a CPU (minutes per case).

CASES and load_frames() are also what the port's tests and chip_smoke.py
encode, so the parameters live in one place. Nothing of thor_tpu or JAX
is imported until main() runs.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
TESTDATA = ROOT / "testdata"
CIF = (TESTDATA / "test_cif.yuv", 352, 288)

# name -> (width, height, EncoderParams fields). Frames are the top-left
# width x height crop of test_cif.yuv's first num_frames frames.
CASES = {
    # 10 intra modes, exact transforms, no block contexts
    "intra_qcif": (176, 144, dict(
        qp=32, intra_period=1, num_frames=2, device_encode=1, intra_rdo=1)),
    # 4 modes, fast transforms, a delta-QP after every 64-SB super mode
    "intra_qcif_fast": (176, 144, dict(
        qp=32, intra_period=1, num_frames=1, device_encode=1, intra_rdo=0,
        encoder_speed=2, max_delta_qp=1, use_block_contexts=1)),
    # full CIF: the frame's last superblock row is partial (288 = 4*64+32)
    "intra_cif": (352, 288, dict(
        qp=32, intra_period=1, num_frames=1, device_encode=1, intra_rdo=1,
        use_block_contexts=1)),
}


def golden_path(name: str) -> Path:
    return TESTDATA / f"torch_enc_{name}.bit"


def crop_frames(path, src_w, src_h, width, height, num_frames):
    """First num_frames frames of a planar 4:2:0 file, cropped top-left
    to width x height: a list of (y, u, v) uint8 arrays."""
    ysz, csz = src_w * src_h, (src_w // 2) * (src_h // 2)
    out = []
    with open(path, "rb") as f:
        for _ in range(num_frames):
            buf = f.read(ysz + 2 * csz)
            if len(buf) < ysz + 2 * csz:
                raise ValueError(f"{path}: fewer than {num_frames} frames")
            y = np.frombuffer(buf, np.uint8, ysz).reshape(src_h, src_w)
            u = np.frombuffer(buf, np.uint8, csz, ysz).reshape(
                src_h // 2, src_w // 2)
            v = np.frombuffer(buf, np.uint8, csz, ysz + csz).reshape(
                src_h // 2, src_w // 2)
            out.append((y[:height, :width].copy(),
                        u[:height // 2, :width // 2].copy(),
                        v[:height // 2, :width // 2].copy()))
    return out


def load_frames(name: str):
    """(fields for EncoderParams(**fields), frames) of one case."""
    width, height, fields = CASES[name]
    fields = dict(fields, width=width, height=height)
    return fields, crop_frames(*CIF, width, height, fields["num_frames"])


def main(argv):
    import time

    from thor_tpu.dec.decoder import decode_file
    from thor_tpu.enc.encoder import Encoder, EncoderParams

    for name in argv or list(CASES):
        fields, frames = load_frames(name)
        out = golden_path(name)
        t0 = time.time()
        recons = Encoder(EncoderParams(**fields)).encode_sequence(
            frames, str(out))
        dec = decode_file(str(out), backend="numpy")
        ok = len(dec) == len(recons) and all(
            np.array_equal(a, b) for d, r in zip(dec, recons)
            for a, b in zip(d, r))
        print(f"{out.name}: {out.stat().st_size} bytes, {len(recons)} "
              f"frames, {time.time() - t0:.0f} s, numpy decode "
              f"{'equals' if ok else 'DIFFERS FROM'} the reconstruction",
              flush=True)
        if not ok:
            out.unlink()
            return 1
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main(sys.argv[1:]))
