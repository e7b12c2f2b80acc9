#!/usr/bin/env python3
"""A/B of two trees of the port on the two 1080p decodes, on one CUDA card.

    python3 tools/ab_decode.py other_tree_dir

"other" is a second checkout of the repo, for instance the parent commit
unpacked with `git archive REV | tar -x -C other_tree_dir`; "tree" is the
checkout this script lies in. In the order other, tree, tree, other, each
in a process of its own started in that tree's root, it decodes
testdata/LDB_medium_complexity_1080.bit and
testdata/RA16_high_efficiency_1080.bit once to warm up and then three
times in a row on the host clock (chip_smoke.timed_decodes: sha256
checked every time, fps median and spread). Then, once per tree, it runs
this tree's thor_tpu_torch/utils/profile_decode.py on that tree's decoder,
so that both are counted by one profiler: on both streams device time by
kernel, device idle share, and the host's parse and input-build ms per
frame; and the kernels that one interpolate_frames call launches on the
RA16 stream's first interpolated frame. Everything is printed; nothing is
compared for you. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
STREAMS = ("LDB_medium_complexity_1080", "RA16_high_efficiency_1080")

FPS = """
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as S
dev = torch.device("cuda")
card = torch.cuda.get_device_name(0)
for name in %r:
    path = S.TESTDATA / (name + ".bit")
    want = (S.TESTDATA / (name + "_dec.sha256")).read_text().split()[0]
    assert S.decode(path, dev)[1] == want
    S.timed_decodes(path, want, dev, card)
""" % (STREAMS,)

# this tree's profiler and the tracing hooks it uses, loaded into the
# package of the tree the process runs in (their other relative imports
# resolve there)
PROFILER = """
import importlib.util, sys
sys.path.insert(0, ".")
import thor_tpu_torch.utils
for name in ("tracing", "profile_decode"):
    spec = importlib.util.spec_from_file_location(
        "thor_tpu_torch.utils." + name, "%s/" + name + ".py")
    P = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = P
    spec.loader.exec_module(P)
""" % (ROOT / "thor_tpu_torch" / "utils",)

PROFILE = PROFILER + "P.main(sys.argv[1:])\n"

LAUNCHES = PROFILER + """
import torch
import chip_smoke as S
from thor_tpu_torch.ops import interp as TI
r1, r2, ratio, pos = S.first_interp_pair(torch.device("cuda"))
run = lambda: TI.interpolate_frames(r1, r2, ratio, pos)
run()
torch.cuda.synchronize()
print(f"interpolate_frames on the 1080p RA16 frame ({ratio},{pos}): "
      f"{P.profile_run(run)[4]} kernels (torch.profiler)", flush=True)
"""


def run(label, tree, argv):
    print(f"=== {label} ({tree}): {' '.join(argv[:4])} ...", flush=True)
    done = subprocess.run([sys.executable] + argv, cwd=tree, text=True,
                          capture_output=True)
    print(done.stdout.rstrip(), flush=True)
    if done.returncode:
        print(done.stderr[-4000:], flush=True)
        raise SystemExit(f"{label}: exit code {done.returncode}")


def main(argv):
    if len(argv) != 2:
        raise SystemExit(__doc__)
    trees = {"other": Path(argv[1]).resolve(), "tree": ROOT}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    for label in ("other", "tree", "tree", "other"):
        run(f"{label} fps", trees[label], ["-c", FPS])
    for label in ("other", "tree"):
        for name in STREAMS:
            run(f"{label} profile", trees[label],
                ["-c", PROFILE, f"testdata/{name}.bit"])
        run(f"{label} launches", trees[label], ["-c", LAUNCHES])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
