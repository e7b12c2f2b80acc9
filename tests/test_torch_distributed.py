"""Multi-process sharded decode of the port over torch.distributed (gloo).

Counterpart of tests/test_distributed.py: two processes on localhost run
`python -m thor_tpu_torch.parallel.worker` with CPU slots; each parses the
whole stream, reconstructs its own gop row's frames, and gathers every
level's planes from the other. Both must print DIST_OK with the golden's
sha256. Tolerance: equal sha256.
"""

import hashlib
import socket
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
TESTDATA = REPO / "testdata"


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# an LDB chain (levels of one frame: the other process's frames arrive as
# host planes) on 2 tile slots a process; an RA stream, whose B frames
# synthesize interpolated references from frames the other process made
@pytest.mark.parametrize("name,tile", [("LDB_low_complexity", 2),
                                       ("RA_low_complexity", 1)])
def test_two_process_sharded_decode(name, tile):
    coord = f"localhost:{_free_port()}"
    gold = TESTDATA / f"{name}_dec.yuv"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "thor_tpu_torch.parallel.worker", coord, "2",
         str(pid), str(TESTDATA / f"{name}.bit"), str(gold), str(tile),
         "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=str(REPO)) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    want = hashlib.sha256(gold.read_bytes()).hexdigest()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"
        assert f"DIST_OK {want}" in out, f"worker {pid}:\n{out[-3000:]}"
