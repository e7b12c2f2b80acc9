"""One process of a multi-process sharded decode.

    python -m thor_tpu_torch.parallel.worker <coordinator> <nproc> <pid> \
        <bitstream> <golden> [tile] [--device cpu] [--eager]

Counterpart of tools/dist_decode_worker.py. Each of the nproc processes
brings up torch.distributed over gloo (coordinator: 'host:port' of
process 0, any free port), parses the whole stream, and reconstructs the
frames of its own gop row of a nproc x tile mesh (tile slots on card pid
modulo the visible cards, each on a stream of its own; --device cpu: CPU
slots); each level's planes are all-gathered to every process
(parallel/mesh.fetch_to_host). golden is a *_dec.yuv file or a
*_dec.sha256 file. The slots replay CUDA graphs on their lanes
(ShardedDecoder(fused=True)); --eager queues the stages one by one.
Prints "DIST_OK <sha256>" when the decode equals the golden, else
"DIST_MISMATCH" and exits 1.
"""

from __future__ import annotations

import argparse
import hashlib
import sys
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m thor_tpu_torch.parallel.worker")
    ap.add_argument("coordinator")
    ap.add_argument("nproc", type=int)
    ap.add_argument("pid", type=int)
    ap.add_argument("bitstream")
    ap.add_argument("golden")
    ap.add_argument("tile", type=int, nargs="?", default=1)
    ap.add_argument("--device", default=None,
                    help="the slots' device (default: card pid modulo the "
                         "visible cards)")
    ap.add_argument("--eager", action="store_true",
                    help="the eager stages (ShardedDecoder(fused=False))")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from .mesh import init_distributed, make_decode_mesh
    from .stream import ShardedDecoder

    rank, world = init_distributed(args.coordinator, args.nproc, args.pid)
    if (rank, world) != (args.pid, args.nproc):
        raise RuntimeError(f"process {args.pid} of {args.nproc} came up as "
                           f"{rank} of {world}")
    try:
        device = args.device
        if device is None:
            n = torch.cuda.device_count()
            device = f"cuda:{args.pid % n}" if n else "cuda"
        mesh = make_decode_mesh([device], gop=args.nproc, tile=args.tile)
        h = hashlib.sha256()
        sd = ShardedDecoder(mesh, fused=not args.eager)
        for planes in sd.iter_frames(args.bitstream):
            for p in planes:
                h.update(p.tobytes())
        gold = Path(args.golden)
        want = gold.read_text().split()[0] if gold.suffix == ".sha256" \
            else hashlib.sha256(gold.read_bytes()).hexdigest()
        if h.hexdigest() != want:
            print(f"DIST_MISMATCH {h.hexdigest()} != {want}", flush=True)
            return 1
        print(f"DIST_OK {h.hexdigest()}", flush=True)
        return 0
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
