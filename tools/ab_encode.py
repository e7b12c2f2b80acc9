#!/usr/bin/env python3
"""A/B of two trees of the port on the 1080p all-intra encode, on one CUDA card.

    python3 tools/ab_encode.py other_tree_dir [--pb] [--json-prefix PREFIX]

"other" is a second checkout of the repo, for instance the parent commit
unpacked with `git archive REV | tar -x -C other_tree_dir`; "tree" is the
checkout this script lies in. In the order other, tree, tree, other, each
in a process of its own started in that tree's root, it runs this tree's
thor_tpu_torch/utils/profile_encode.py (and the profile_run of this tree's
profile_decode.py) on that tree's encoder, so that both trees are timed
and profiled by one script with one profiler setting: three frames on the
host clock, then one frame under torch.profiler (kernel launches, device
busy and idle share); with --pb, profile_encode's --pb form instead (the
LDB-form I P P P encode, its last P frame profiled). Each run's JSON object is printed, and written to
PREFIX_<i>_<label>.json when --json-prefix is given. Nothing is compared
for you. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
UTILS = ROOT / "thor_tpu_torch" / "utils"

# this tree's profilers and the tracing hooks they use, loaded into the
# package of the tree the process runs in (their relative imports of the
# encoder resolve there)
PROFILE = """
import importlib.util, sys
sys.path.insert(0, ".")
import thor_tpu_torch.utils
for name in ("tracing", "profile_decode", "profile_encode"):
    spec = importlib.util.spec_from_file_location(
        "thor_tpu_torch.utils." + name, "%s/" + name + ".py")
    m = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = m
    spec.loader.exec_module(m)
m.main(sys.argv[1:])
""" % (UTILS,)


def main(argv):
    pb = "--pb" in argv
    argv = [a for a in argv if a != "--pb"]
    if len(argv) not in (2, 4) or (len(argv) == 4
                                   and argv[2] != "--json-prefix"):
        raise SystemExit(__doc__)
    trees = {"other": Path(argv[1]).resolve(), "tree": ROOT}
    prefix = argv[3] if len(argv) == 4 else None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    for i, label in enumerate(("other", "tree", "tree", "other"), 1):
        args = ["-c", PROFILE] + (["--pb"] if pb else [])
        if prefix:
            args += ["--json", str(Path(f"{prefix}_{i}_{label}.json")
                                   .resolve())]
        print(f"=== {i} {label} ({trees[label]})", flush=True)
        done = subprocess.run([sys.executable] + args, cwd=trees[label],
                              text=True, capture_output=True)
        print(done.stdout.rstrip(), flush=True)
        if done.returncode:
            print(done.stderr[-4000:], flush=True)
            raise SystemExit(f"{i} {label}: exit code {done.returncode}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
