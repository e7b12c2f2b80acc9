"""The control of a cell's comparison: the plain reference in the
program's place, computed one step below the precision the configuration
states, must come out as not correct.

    python3 -m benchmark.control --workload <cell> --seeds 11 12 13
        [--seconds 5] [--device cuda]

The configuration states exact integer arithmetic (an encoder whose
stream decodes to its reconstruction). The control breaks that guarantee
the way a faster program might: the reference's inverse transform runs
as bfloat16 products summed in float32, as a tensor-core GEMM would
(reference/np_kernels.LOW_PRECISION). For each seed it runs the cell's
traffic for a window at its own load, then:

  - reads the comparison as the run would (the sound reading);
  - puts the control's output in the program's place (the control's
    decode of each written stream for the encoder's reconstruction) and
    reads the same comparison again (the control's reading).

With --fault speed2 or no_second_chance it instead runs the program
with that fault planted (FAULTS: its own encoder_speed 2 path; the P
frames' second chance left out) and reads the comparison: the rate and
quality numbers, which the control leaves as they are, must fail under
them. --fault sound reads the sound program alone.

Prints one JSON line per seed and the readings on standard error. The
benchmark's own runs never run it. Without a card it exits with code 2
unless --device cpu is given (the tests' size).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

# faults planted in the program (planted()): its own encoder_speed 2 path,
# and the P frames' second chance left out
FAULTS = ("speed2", "no_second_chance")


def control_decode(stream):
    """The reference's decode of `stream` with the bfloat16 inverse
    transform."""
    from .reference import np_kernels
    from .reference.decode import decode
    np_kernels.LOW_PRECISION[0] = True
    try:
        return decode(stream)
    finally:
        np_kernels.LOW_PRECISION[0] = False


def swap_in_control(traffic) -> None:
    """Replace the reconstructions `traffic` kept for its comparison by
    the control's decode of each stream it wrote."""
    streams = [path.read_bytes() for path, *_ in traffic.done]
    workers = min(len(streams), int(getattr(traffic, "workers", 1)))
    if workers > 1:
        import multiprocessing as mp
        with mp.get_context("spawn").Pool(workers) as pool:
            frames = pool.map(control_decode, streams, chunksize=1)
    else:
        frames = [control_decode(x) for x in streams]
    traffic.done = [(path, f, *rest) for (path, _, *rest), f in
                    zip(traffic.done, frames)]


@contextlib.contextmanager
def planted(traffic, fault):
    """The program run with `fault` (FAULTS) planted, for the readings
    that set the upper end of a number that the control does not reach."""
    if fault == "speed2":
        traffic.fields["encoder_speed"] = 2
        yield
    elif fault == "no_second_chance":
        from thor_tpu_torch.enc import device_inter, fused
        saved = device_inter.second_chance, fused.second_chance
        device_inter.second_chance = fused.second_chance = \
            lambda *a, **k: False
        try:
            yield
        finally:
            device_inter.second_chance, fused.second_chance = saved
    else:
        yield


def readings(root: Path, name: str, seeds, seconds: float, device,
             fault: str = "control"):
    """[{"seed", "sound": {check: value}, "control": {check: value}}]
    with fault "control"; with a fault of FAULTS, [{"seed", "fault",
    "faulted": {check: value}, "rd"}] of the program run with it; with
    "sound", the sound readings alone."""
    import torch
    from . import harness
    dev = torch.device(device)
    found = harness.find_cell(harness.benchmark_spec(root), name,
                              root / "benchmark")
    cls = harness.traffic_class(found["cell"]["kind"])
    out = []
    for seed in seeds:
        t = cls(root, found["config"], found["cell"]["params"], seed, dev)
        with planted(t, fault):
            t.setup(seconds)
            rate = t.window(seconds)
            t.release()
            try:
                sound = {c.name: c.value for c in t.check()}
                row = {"seed": seed, "fault": fault, "window": rate,
                       "rd": getattr(t, "rd_readings", None)}
                if fault == "control":
                    swap_in_control(t)
                    ctl = t.check()
                    row.update(sound=sound,
                               control={c.name: c.value for c in ctl},
                               control_correct=all(c.ok for c in ctl))
                elif fault == "sound":
                    row["sound"] = sound
                else:
                    row["faulted"] = sound
            finally:
                t.close()
        out.append(row)
        print(json.dumps(row), flush=True)
        print(f"seed {seed} {fault}: "
              + ", ".join(f"{k} {v}" for k, v in (
                  row.get("control") or row.get("faulted")
                  or row["sound"]).items()), file=sys.stderr, flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--fault", default="control",
                    choices=("control", "sound") + FAULTS)
    args = ap.parse_args(argv)
    import torch
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    readings(Path.cwd(), args.workload, args.seeds, args.seconds,
             args.device, args.fault)
    return 0


if __name__ == "__main__":
    sys.exit(main())
