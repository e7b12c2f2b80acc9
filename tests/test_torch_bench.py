"""The bench twin (thor_tpu_torch/bench.py) on the CPU: its children at CIF
and QCIF size, held against the goldens and against thor_tpu (the decode
digests against thor_tpu's frame_digest_np, the synthetic frame against
thor_tpu's _frame_fn, the encode against thor_tpu's committed bytes);
the parent with the child processes stubbed, its line's keys against
bench.py's (BENCH_r05.json) and its exit code on every failure; and the
real parent in this process's environment, which has no card. Tolerance:
equality throughout."""

import hashlib
import json
import subprocess
import sys
from functools import partial

import jax
import numpy as np
import pytest
import torch

from thor_tpu.dec.decoder import frame_digest_np
from thor_tpu.dec.reconstruct_jax import _frame_fn
from thor_tpu.utils.synth import build_synthetic_frame as synth0

from thor_tpu_torch import bench as B
from thor_tpu_torch.ops import interp as TI
from thor_tpu_torch.ops import mc as MC

from tools.gen_torch_enc_goldens import golden_path, load_frames

from .conftest import REPO, TESTDATA

LDB = TESTDATA / "LDB_low_complexity.bit"
CIF = (352, 288)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in parallel processes, and a
    busy CPU makes PyTorch's thread pool many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _golden_frames(name, W, H):
    data = np.fromfile(TESTDATA / f"{name}_dec.yuv", np.uint8)
    fs = W * H * 3 // 2
    for k in range(len(data) // fs):
        f = data[k * fs:(k + 1) * fs]
        yield (f[:W * H].reshape(H, W),
               f[W * H:W * H * 5 // 4].reshape(H // 2, W // 2),
               f[W * H * 5 // 4:].reshape(H // 2, W // 2))


# ---------------------------------------------------------------------------
# the children, in this process, on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wrong", [False, True])
def test_child_decode_gate(wrong):
    """The golden's sha256 gives bit_exact and an fps; another gives no
    number and says why."""
    want = hashlib.sha256(
        (TESTDATA / "LDB_low_complexity_dec.yuv").read_bytes()).hexdigest()
    r = B.child_decode(LDB, "0" * 64 if wrong else None, device="cpu")
    assert B.golden_sha256(LDB) == want
    assert r["frames"] == 10 and r["bit_exact"] is not wrong
    if wrong:
        assert r["fps"] is None and "golden" in r["failed"]
    else:
        assert r["fps"] > 0 and r["failed"] is None


@pytest.mark.parametrize("wrong", [False, True])
def test_child_decode_verify_digests_equal_thor_tpus(wrong):
    """The timed digest decode's checksums equal thor_tpu's
    frame_digest_np over the golden planes; a wrong golden sha256 gives
    no number."""
    want = [int(frame_digest_np(*f))
            for f in _golden_frames("LDB_low_complexity", *CIF)]
    r = B.child_decode_verify(LDB, "0" * 64 if wrong else None,
                              device="cpu")
    assert len(want) == 10 and r["digests"] == want
    assert r["verified"] is not wrong
    assert (r["fps"] is None) is wrong and (r["failed"] is None) is not wrong


def test_child_decode_ra16_equals_golden_with_interpolated_refs():
    n0 = TI.me_level_plain.calls
    r = B.child_decode_ra16(TESTDATA / "RA_low_complexity.bit",
                            device="cpu")
    assert r["bit_exact"] and r["fps"] > 0 and r["frames"] == 10
    assert TI.me_level_plain.calls > n0        # kernel 3's plain version


def test_child_synth_frame_and_loop():
    """At 192x136 (a last band cut to 8 rows, as 1080 lines cut theirs):
    the bench's frame has the sum of thor_tpu's _frame_fn planes on
    thor_tpu's synthetic frame of the same seed, in every one of its
    2 + 3 x 8 frames, and equals the plain versions' frame."""
    W, H = 192, 136
    cfg0, inp0 = synth0(W, H, R=2)
    cpu = jax.devices("cpu")[0]
    planes0 = jax.jit(partial(_frame_fn, cfg0))(jax.device_put(inp0, cpu))
    n0 = MC.mc_frame_plain.calls
    r = B.child_synth(W, H, device="cpu")
    # one frame on the device, one on the CPU for the gate, then the loop
    assert MC.mc_frame_plain.calls - n0 == 2 * (2 + 2 + 3 * 8)
    assert r["equal_to_plain"] and r["failed"] is None and r["fps"] > 0
    assert r["sum"] == sum(int(np.asarray(p, np.int64).sum())
                           for p in planes0)


def test_child_encode_decodes_back_to_thor_tpus_bytes():
    """A 2-frame QCIF all-intra crop (tools/gen_torch_enc_goldens
    intra_qcif): the stream decodes back to the reconstruction and is
    thor_tpu's committed stream byte for byte."""
    fields, frames = load_frames("intra_qcif")
    r = B.child_encode(frames, fields, device="cpu")
    assert r["decodes_back"] and r["fps"] > 0 and r["frames"] == 2
    assert r["sha256"] == hashlib.sha256(
        golden_path("intra_qcif").read_bytes()).hexdigest()


def test_link_and_probe_raise_on_the_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        B.child_link(device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        B.child_probe(device="cpu")


# ---------------------------------------------------------------------------
# the parent, its child processes stubbed
# ---------------------------------------------------------------------------

CANNED = {
    "probe": {"backend": "cuda", "device": "NVIDIA H100 80GB HBM3",
              "power_limit": "700.00 W"},
    "decode": {"fps": 20.0, "failed": None, "frames": 17,
               "bit_exact": True},
    "decode_verify": {"fps": 22.0, "failed": None, "verified": True},
    "decode_ra16": {"fps": 16.0, "failed": None, "bit_exact": True},
    "decode_device": {"fps": 80.0},
    "link": {"link_floor_fps": 8000.0, "d2h_MBps": 25000.0, "h2d_ms": 0.5},
    "synth": {"fps": 90.0, "failed": None},
    "encode": {"fps": 0.5, "failed": None, "decodes_back": True},
    "encode_device": {"fps": 0.8},
}


def _parent(monkeypatch, capsys, fail=None, how=None, canned=CANNED):
    """main() with subprocess.run answering for each child from `canned`;
    the child `fail` times out, exits 1 or prints no JSON (`how`).
    Returns (rc, the line, the children run)."""
    ran = []

    def run(argv, **kw):
        name = argv[-1]
        ran.append(name)
        if name == fail and how == "timeout":
            raise subprocess.TimeoutExpired(argv, kw["timeout"])
        rc, out = 0, json.dumps(canned[name])
        if name == fail:
            rc, out = (1, "") if how == "rc" else (0, "no line")
        return subprocess.CompletedProcess(argv, rc, out + "\n",
                                           "Traceback\nboom\n")

    monkeypatch.setattr(B.subprocess, "run", run)
    rc = B.main([])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    return rc, json.loads(lines[0]), ran


def test_parent_line_keys_are_bench_pys(monkeypatch, capsys):
    rc, line, ran = _parent(monkeypatch, capsys)
    parsed = json.loads((REPO / "BENCH_r05.json").read_text())["parsed"]
    assert rc == 0 and "error" not in line
    assert set(line) == set(parsed) | {"power_limit", "h2d_ms",
                                       "encode_form"}
    assert ran == ["probe"] + [c[0] for c in B.CHILDREN]
    assert line["metric"] == "1080p_decode_e2e_fps" and line["value"] == 20.0
    assert line["vs_baseline"] == round(20.0 / 60, 3)
    assert line["backend"] == "cuda" and line["power_limit"] == "700.00 W"
    assert line["e2e_pct_of_link_floor"] == 0.2
    assert line["encode_device_vs_baseline"] == round(0.8 / 60, 3)


@pytest.mark.parametrize("how", ["timeout", "rc", "nojson"])
@pytest.mark.parametrize("fail,keys", [
    ("decode", ("value", "vs_baseline", "bit_exact", "frames",
                "e2e_pct_of_link_floor")),
    ("decode_ra16", ("ra16_1080_decode_fps", "ra16_1080_bit_exact")),
    ("encode_device", ("encode_device_fps", "encode_device_vs_baseline"))])
def test_parent_names_a_failed_child(monkeypatch, capsys, fail, keys, how):
    rc, line, ran = _parent(monkeypatch, capsys, fail, how)
    assert rc == 1 and line["error"].startswith(f"{fail}: ")
    assert all(line[k] is None for k in keys)
    assert line["decode_device_fps"] == 80.0     # the others still ran
    assert len(ran) == 1 + len(B.CHILDREN)


def test_parent_gate_failure_gives_no_number(monkeypatch, capsys):
    canned = dict(CANNED, decode_verify={
        "fps": None, "failed": "the timed checksums differ",
        "verified": False})
    rc, line, _ = _parent(monkeypatch, capsys, canned=canned)
    assert rc == 1 and line["decode_e2e_verify_fps"] is None
    assert line["decode_verify_ok"] is False
    assert line["error"] == "decode_verify: the timed checksums differ"
    assert line["value"] == 20.0


def test_parent_without_a_card_runs_no_child(monkeypatch, capsys):
    rc, line, ran = _parent(monkeypatch, capsys, "probe", "rc")
    assert rc == 1 and ran == ["probe"] and line["value"] is None
    assert "no usable CUDA card" in line["error"]
    assert all(line[k] is None for k in line
               if k not in ("metric", "unit", "backend", "encode_form",
                            "error"))


def test_parent_switches(monkeypatch, capsys):
    """THOR_BENCH_ENCODE=0 skips both encode children, as in bench.py."""
    monkeypatch.setenv("THOR_BENCH_ENCODE", "0")
    rc, line, ran = _parent(monkeypatch, capsys)
    assert rc == 0 and "encode" not in ran and "encode_device" not in ran
    assert line["1080p_encode_e2e_fps"] is None and line["value"] == 20.0


def test_bench_without_a_card_exits_1():
    """The real parent here, where there is no card: one line, no
    number, exit 1."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "-m", "thor_tpu_torch.bench"],
                       cwd=REPO, capture_output=True, text=True, timeout=60)
    lines = r.stdout.strip().splitlines()
    assert r.returncode == 1 and len(lines) == 1
    line = json.loads(lines[0])
    assert line["value"] is None and "no CUDA device" in line["error"]
