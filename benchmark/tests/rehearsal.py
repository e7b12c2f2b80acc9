"""A small checkout for the CPU rehearsal: a BENCHMARK.json whose cell
runs the LDB configuration's encoder at QCIF size, beside the benchmark's
own readers and traffic kinds."""

from __future__ import annotations

import copy
import json
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "benchmark"

QCIF_FRAMES = 3
# the rate and quality of the two bank clips at QCIF, as the CPU encodes
# them (bank_clip 0 and 1: 3 frames each), and limits that the program
# with its lambdas x8 fails by far (its PSNR falls by 2 dB and more)
ENC_PARAMS = {"nominal_fps": 1, "bank": 2, "warm_frames": QCIF_FRAMES,
              "check_workers": 1,
              "rd": {"bytes": [618, 752],
                     "psnr_db": [37.9577, 37.7568],
                     "bytes_excess_pct": 1.0, "psnr_drop_db": 0.05}}


def qcif_config() -> dict:
    """The LDB configuration's encoder settings at QCIF (a superblock
    fits), in clips of QCIF_FRAMES: the published frame structure's first
    frames."""
    cfg = json.loads((BENCH / "configs" / "ldb_1080.json").read_text())
    cfg.update(width=176, height=144, frames=QCIF_FRAMES,
               sequence=cfg["sequence"][:QCIF_FRAMES])
    return cfg


def small_root(tmp: Path) -> Path:
    """A checkout under `tmp` whose one cell, "qcif.enc", runs the LDB
    configuration's encoder at QCIF, with the real BENCHMARK.json's
    metrics. Returns its root."""
    root = tmp / "root"
    (root / "benchmark" / "configs").mkdir(parents=True)
    (root / "benchmark" / "workloads").mkdir()
    (root / "benchmark" / "metrics").symlink_to(BENCH / "metrics")
    spec = copy.deepcopy(json.loads((REPO / "BENCHMARK.json").read_text()))
    spec["configs"] = [
        {"name": "qcif", "source": "test",
         "file": "benchmark/configs/qcif.json", "reduced": [],
         "why": "rehearsal"}]
    spec["workloads"] = [{"name": "qcif.enc", "config": "qcif",
                          "traffic": "enc", "chips": 1, "why": "rehearsal"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["qcif.enc"]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    (root / "benchmark" / "configs" / "qcif.json").write_text(
        json.dumps(qcif_config()))
    (root / "benchmark" / "workloads" / "qcif.enc.json").write_text(
        json.dumps({"config": "qcif", "traffic": "enc",
                    "kind": "encode_live",
                    "params": ENC_PARAMS}))
    return root
