#!/usr/bin/env python3
"""Write the decoder statistics reports of the PyTorch/CUDA port.

    JAX_PLATFORMS=cpu python3 tools/gen_torch_dec_stats.py [stream ...]

`python -m thor_tpu_torch.dec` prints Thordec's bit and mode statistics
(dec/maindec.c:197-329) text for text as `python -m thor_tpu.dec` does.
A machine with a CUDA card has no JAX, so the oracle's reports are kept as
data: this tool runs thor_tpu's CLI (numpy backend) on each stream of
STREAMS (or the named ones) and writes testdata/torch_dec_stats_<stream>.txt,
the text after its timing line. Each file is written as <file>.part and
renamed when complete. On a CPU the CIF streams take seconds each, the
1080p ones a few minutes.

STREAMS and report_path() are also what the port's tests and chip_smoke.py
read, so the list lives in one place. Nothing of thor_tpu or JAX is
imported until main() runs.
"""

from __future__ import annotations

import contextlib
import io
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TESTDATA = ROOT / "testdata"

CIF_STREAMS = ("intra_only", "LDB_low_complexity", "LDB_medium_complexity",
               "LDB_high_efficiency", "RA_low_complexity",
               "RA16_high_efficiency", "HDB16_medium_complexity")
STREAMS = CIF_STREAMS + ("RA16_long", "LDB_medium_complexity_1080",
                         "RA16_high_efficiency_1080")


def report_path(name: str) -> Path:
    return TESTDATA / f"torch_dec_stats_{name}.txt"


def after_timing_line(text: str) -> str:
    """The report: everything a decoder CLI prints after its first line."""
    return text.split("\n", 1)[1]


def thor_tpu_report(name: str, out_yuv: str) -> str:
    """thor_tpu's CLI on testdata/<name>.bit (numpy backend, statistics
    always on), decoded frames to out_yuv; the text after its timing
    line."""
    from thor_tpu.dec.__main__ import main as tpu_main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tpu_main([str(TESTDATA / f"{name}.bit"), out_yuv,
                       "--backend", "numpy"])
    if rc != 0:
        raise RuntimeError(f"thor_tpu's decoder failed on {name}")
    return after_timing_line(buf.getvalue())


def main(argv):
    import tempfile
    sys.path.insert(0, str(ROOT))
    names = argv or list(STREAMS)
    for name in names:
        if name not in STREAMS:
            raise SystemExit(f"unknown stream {name}; one of {STREAMS}")
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            text = thor_tpu_report(name, str(Path(tmp) / "out.yuv"))
            out = report_path(name)
            part = out.with_name(out.name + ".part")
            part.write_text(text)
            part.replace(out)
            print(f"{out.relative_to(ROOT)}: {len(text.splitlines())} lines",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
