"""Thordec-equivalent CLI (dec/maindec.c:91-345).

Usage: python -m thor_tpu_torch.dec in.bit out.yuv [--backend torch|numpy]
                                                  [--device cpu|cuda]
                                                  [--mesh GxT]

Decodes on the card by default (--backend torch); --device cpu runs the
kernels' plain PyTorch versions on the CPU; --backend numpy runs the exact
host oracle and uses no device. After the timing line it prints the
reference's bit and mode statistics (bit_count_t, dec/maindec.c:197-329)
text for text as `python -m thor_tpu.dec` does; they come from the
instrumented Python parser, which the decoder therefore always uses here.
--mesh decodes through the gop x tile sharded decoder (parallel/stream.py)
and prints, as thor_tpu's CLI does, one line with the level sizes and no
statistics.
"""

from __future__ import annotations

import argparse
import io
import sys
import time

from ..codec.constants import (
    MODE_BIPRED, MODE_INTER, MODE_INTRA, MODE_MERGE, MODE_SKIP)


def report(st: dict) -> str:
    """Thordec's statistics report of a Decoder's `stats`, the text that
    thor_tpu/dec/__main__.py:58-162 prints after its timing line."""
    buf = io.StringIO()

    def _p(*a):
        print(*a, file=buf)

    mode_names = {MODE_SKIP: "skip", MODE_INTRA: "intra",
                  MODE_INTER: "inter", MODE_BIPRED: "bipred",
                  MODE_MERGE: "merge"}
    _p("\nFrame types:   ",
       "  ".join(f"{k}:{v}" for k, v in sorted(st["frame_type"].items())))
    _p("Bits by type:  ",
       "  ".join(f"{k}:{v}" for k, v in sorted(st["frame_bits"].items())))
    # per-category bit report (dec/maindec.c:219-238)
    cats = ("frame_header", "super_mode", "intra_mode", "mv", "skip_idx",
            "coeff_y", "coeff_u", "coeff_v", "cbp", "clpf")
    nf = {ft: st["frame_type"].get(ft, 0) for ft in ("I", "P", "B")}
    _p("\nBIT STATISTICS:")
    _p(f"Sequence header: {st['seq_header']:6d}")
    _p(f"{'':22s}" + "".join(
        f"{ft + ' pictures:':>22s}" for ft in ("I", "P", "B")))
    _p(f"{'':22s}" + "      total    average" * 3)
    tot = {ft: 0 for ft in ("I", "P", "B")}
    for cat in cats:
        row = f"{cat:<22s}"
        for ft in ("I", "P", "B"):
            v = st["cats"].get((ft, cat), 0)
            tot[ft] += v
            row += f"{v:11d}{v // max(nf[ft], 1):11d}"
        _p(row)
    row = f"{'Total:':<22s}"
    tot["I"] += st["seq_header"]
    for ft in ("I", "P", "B"):
        row += f"{tot[ft]:11d}{tot[ft] // max(nf[ft], 1):11d}"
    _p(row)

    # size x mode cross tables (dec/maindec.c:253-266)
    for ft in ("P", "B"):
        if not any(f == ft for (f, _, _) in st["size_mode"]):
            continue
        _p(f"\nMode and size distribution for {ft} pictures:")
        _p(f"{'':22s}{'SKIP':>9s}  {'INTRA':>9s}  {'INTER':>9s}  "
           f"{'BIPRED':>9s}  {'MERGE':>9s}")
        for sz in (8, 16, 32, 64):
            row = f"{sz}x{sz}-blocks (8x8):"
            row = f"{row:<22s}"
            for md in (MODE_SKIP, MODE_INTRA, MODE_INTER, MODE_BIPRED,
                       MODE_MERGE):
                row += f"{st['size_mode'].get((ft, sz, md), 0):9d}  "
            _p(row.rstrip())

    # super-mode distribution (dec/maindec.c:268-291)
    nref = max(st.get("num_ref_max", 1), 1)
    sm_cols = ["SKIP", "SPLIT", "INTERr0", "MERGE", "BIPRED", "INTRA"] \
        + [f"INTERr{i}" for i in range(1, nref)]
    for ft in ("P", "B"):
        if not any(f == ft for (f, _, _) in st["super_stat"]):
            continue
        _p(f"\nSuper-mode distribution for {ft} pictures:")
        _p(f"{'':16s}" + "".join(f"{c:>9s}" for c in sm_cols))
        for sz in (8, 16, 32, 64):
            row = f"{sz:2d} x {sz:2d}-blocks:"
            row = f"{row:<16s}"
            for c in range(len(sm_cols)):
                row += f"{st['super_stat'].get((ft, sz, c), 0):9d}"
            _p(row)

    # ref_idx x size distribution (dec/maindec.c:293-315)
    for ft in ("P", "B"):
        if not any(f == ft for (f, _, _) in st["size_ref"]):
            continue
        _p(f"\nRef_idx and size distribution for {ft} pictures:")
        for sz in (8, 16, 32, 64):
            row = f"{sz:2d} x {sz:2d}-blocks:"
            row = f"{row:<16s}"
            for r in range(nref):
                row += f"{st['size_ref'].get((ft, sz, r), 0):6d}"
            _p(row)

    # bi-ref pair counts (dec/maindec.c:316-325)
    for ft in ("P", "B"):
        if any(f == ft for (f, _) in st["bi_ref"]):
            row = f"bi-ref-{ft}:  "
            for j in range(16):
                row += f"{st['bi_ref'].get((ft, j), 0):7d}"
            _p(row)

    _p("\nPARAMETER STATISTICS (8x8 units):")
    for ft in ("I", "P", "B"):
        modes = {mode_names[m]: c for (f, m), c in st["mode"].items()
                 if f == ft}
        sizes = {s: c for (f, s), c in st["size"].items() if f == ft}
        if modes:
            _p(f"{ft}-frame modes: ",
               "  ".join(f"{k}:{v}" for k, v in sorted(modes.items())))
            _p(f"{ft}-frame sizes: ",
               "  ".join(f"{k}:{v}" for k, v in sorted(sizes.items())))
    return buf.getvalue()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m thor_tpu_torch.dec")
    ap.add_argument("bitstream")
    ap.add_argument("output")
    ap.add_argument("--backend", choices=("torch", "numpy"), default="torch")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--eager", action="store_true",
                    help="queue the frame program stage by stage instead "
                         "of replaying one CUDA graph per frame signature "
                         "(Decoder(fused=False); with --mesh "
                         "ShardedDecoder(fused=False))")
    ap.add_argument("--mesh", metavar="GxT",
                    help="decode through the gop x tile sharded decoder "
                         "(parallel/stream.py), e.g. --mesh 2x4; slots "
                         "share the visible cards on streams of their own "
                         "(on --device cpu, CPU slots)")
    args = ap.parse_args(argv)

    if args.mesh is not None:
        from ..parallel.stream import ShardedDecoder
        gop, tile = (int(x) for x in args.mesh.split("x"))
        devices = None if args.device == "cuda" else [args.device]
        sd = ShardedDecoder(gop=gop, tile=tile, devices=devices,
                            fused=not args.eager)
        n = 0
        t0 = time.perf_counter()
        with open(args.output, "wb") as out:
            for (y, u, v) in sd.iter_frames(args.bitstream):
                out.write(y.tobytes() + u.tobytes() + v.tobytes())
                n += 1
        dt = time.perf_counter() - t0
        print(f"decoded {n} frames in {dt:.2f}s "
              f"({n / dt:.2f} frames/s, mesh={gop}x{tile}, "
              f"gop-level batches={sd.last_level_sizes})")
        return 0

    from .decoder import Decoder

    dec = Decoder(device=args.device, backend=args.backend,
                  collect_stats=True, fused=not args.eager)
    n = 0
    t0 = time.perf_counter()
    with open(args.output, "wb") as out:
        for (y, u, v) in dec.decode_stream(args.bitstream):
            out.write(y.tobytes() + u.tobytes() + v.tobytes())
            n += 1
    dt = time.perf_counter() - t0
    where = f"device={dec.device}" if dec.device is not None else "host"
    print(f"decoded {n} frames in {dt:.2f}s ({n / dt:.2f} frames/s, "
          f"backend={args.backend}, {where})")
    sys.stdout.write(report(dec.stats))
    return 0


if __name__ == "__main__":
    sys.exit(main())
