"""The benchmark's harness: it finds a cell's files by name, runs the cell
once and prints its result.

Everything that belongs to one configuration, one cell, one traffic kind
or one per-layer metric sits in files of its own, found by the names in
BENCHMARK.json:

  - configs/<config>.json: a deployment (its source, its sizes, its
    settings, the guarantees the comparison holds it to);
  - workloads/<cell>.json: the cell's configuration, its traffic kind
    and the kind's parameters;
  - traffic/<kind>.py: the generator of one kind of traffic (a class
    Traffic, see traffic/__init__.py);
  - metrics/<metric>.py: the reader of one per-layer metric (read(trace)
    -> a number, or None where it finds nothing to read).

run_cell() runs one cell once: set-up (the program's import, its kernels'
load, the traffic's warm-up), the measured window, with trace=True the
traced sub-window and the per-layer readers, the device's readings, then
the comparison with the plain reference that decides `correct`. The
CPU rehearsal (device="cpu") runs the same steps and is for the tests
only: benchmark/run.py refuses to run without a card.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# modules that no run may load, compared by their whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "thor_tpu")


class CellError(Exception):
    """A cell or metric the files do not define as BENCHMARK.json says."""


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def benchmark_spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def find_cell(spec: dict, name: str, bench_dir: Path = BENCH_DIR) -> dict:
    """The cell `name`: its BENCHMARK.json entry ("entry"), its file
    ("cell"), its configuration's entry ("config_entry") and file
    ("config"), its end-to-end and per-layer metrics."""
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise CellError(f"BENCHMARK.json has no workload {name!r}")
    cell = load_json(bench_dir / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if cell.get(key) != entry[key]:
            raise CellError(f"workloads/{name}.json says {key} "
                            f"{cell.get(key)!r}, BENCHMARK.json "
                            f"{entry[key]!r}")
    cfg_entry = next(c for c in spec["configs"] if c["name"] == entry[
        "config"])
    config = load_json(bench_dir.parent / cfg_entry["file"])
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    return {"entry": entry, "cell": cell, "config_entry": cfg_entry,
            "config": config, "end_to_end": e2e, "per_layer": per_layer}


def traffic_class(kind: str):
    """The Traffic class of traffic/<kind>.py."""
    return importlib.import_module(f"benchmark.traffic.{kind}").Traffic


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """read() of metrics/<name>.py (loaded from its file: a metric's name
    holds dots)."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics._m_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """The modules loaded in this process whose top-level name is one of
    FORBIDDEN."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


class Check:
    """One number compared with its limit: value <= limit (or, with
    at_least, value >= limit)."""

    def __init__(self, name, value, limit, at_least=False):
        self.name, self.value, self.limit = name, value, limit
        self.at_least = at_least

    @property
    def ok(self) -> bool:
        return bool(self.value >= self.limit if self.at_least
                    else self.value <= self.limit)

    def line(self) -> str:
        op = ">=" if self.at_least else "<="
        return (f"check {self.name} {self.value} {op} {self.limit} "
                f"{'ok' if self.ok else 'FAILED'}")

    def as_json(self) -> dict:
        return {"value": self.value, "limit": self.limit,
                "op": ">=" if self.at_least else "<=", "ok": self.ok}


def device_info(device, count: int) -> dict:
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    peak = max(torch.cuda.max_memory_allocated(torch.device("cuda", i))
               for i in range(count))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak),
            "power_limit": power_limit()}


def power_limit() -> str | None:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else None


def host_clocks():
    """(wall s, this process's CPU s: user and system, all threads)."""
    import os
    t = os.times()
    return time.perf_counter(), t.user + t.system


def host_share(a, b) -> dict:
    """The window's wall seconds and the cores this process kept busy in
    it (its CPU seconds over them), between two host_clocks() readings."""
    wall = b[0] - a[0]
    return {"window_s": wall,
            "process_cores": (b[1] - a[1]) / wall if wall > 0 else None}


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, root: Path = ROOT, log=None) -> dict:
    """Run cell `name` once on `device` ("cuda" or, for the tests, "cpu").
    t_start: the process's start on the time.time() clock (setup_s runs
    from it). Returns the result object (the last line run.py prints);
    stderr gets the compared numbers."""
    import torch
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    dev = torch.device(device)
    spec = benchmark_spec(root)
    found = find_cell(spec, name, root / "benchmark")
    entry, cell = found["entry"], found["cell"]
    chips = entry["chips"] if dev.type == "cuda" else 1
    traffic = traffic_class(cell["kind"])(
        root, found["config"], cell["params"], seed, dev)
    if dev.type == "cuda":
        torch.cuda.init()
        for i in range(chips):
            torch.cuda.reset_peak_memory_stats(torch.device("cuda", i))
    traffic.setup(seconds)
    setup_s = time.time() - t_start
    host0 = host_clocks()
    measured = traffic.window(seconds)
    host = host_share(host0, host_clocks())
    metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
    for m in found["end_to_end"]:
        if m["name"] in measured:
            metrics[m["name"]] = {"value": measured[m["name"]],
                                  "unit": m["unit"]}
    missing = [m["name"] for m in found["end_to_end"]
               if m["name"] not in metrics]
    if missing:
        raise CellError(f"cell {name} measured no {missing}")
    result = {"correct": False, "attempted": traffic.attempted,
              "failed": traffic.failed}
    info = {}
    if trace:
        tr = traffic.traced()
        layer = {}
        for m in found["per_layer"]:
            v = metric_reader(m["name"], root / "benchmark")(tr)
            if v is not None:
                layer[m["name"]] = {"value": v, "unit": m["unit"]}
        metrics = layer
        info = {"busy_s": tr.busy_s(), "window_s": tr.window_s}
        result["breakdown"] = tr.breakdown()
    device_fields = device_info(dev, chips)
    device_fields.update(info)
    traffic.release()
    try:
        checks = traffic.check()
        notes = traffic.notes()
    finally:
        traffic.close()
    bad = forbidden_modules()
    if bad:
        raise CellError(f"the run loaded forbidden modules: {bad}")
    result.update(attempted=traffic.attempted, failed=traffic.failed,
                  correct=bool(checks) and all(c.ok for c in checks),
                  metrics=metrics, device=device_fields)
    result.update(notes)
    result["host"] = host
    result["checks"] = {c.name: c.as_json() for c in checks}
    for c in checks:
        log(c.line())
    return result
