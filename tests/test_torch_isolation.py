"""The port stands alone: importing every thor_tpu_torch module pulls in
neither jax nor thor_tpu, and the entry points refuse to run on a missing
card unless the caller asks for the CPU."""

import subprocess
import sys

import pytest
import torch

from thor_tpu_torch import bench
from thor_tpu_torch.dec.decoder import Decoder, decode_file
from thor_tpu_torch.device import resolve_device
from thor_tpu_torch.enc.encoder import Encoder, EncoderParams, encode_file
from thor_tpu_torch.parallel.encode import ShardedEncoder
from thor_tpu_torch.parallel.stream import ShardedDecoder
from thor_tpu_torch.utils import (device_decode_fps, device_encode_fps,
                                  encode_4k, encode_scaling, link_profile,
                                  scaling_curve)

from .conftest import REPO, TESTDATA

_PROBE = r"""
import importlib, pkgutil, sys
import thor_tpu_torch
names = [m.name for m in pkgutil.walk_packages(thor_tpu_torch.__path__,
                                               "thor_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "thor_tpu"
             or m.startswith("thor_tpu."))
print(len(names), "modules", *names)
assert not bad, bad
"""


def test_port_imports_no_jax_and_no_thor_tpu():
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    out = r.stdout.split()
    assert int(out[0]) >= 63       # the enc package, host mirror, the
    #                                 numpy decode backend, the parallel
    #                                 paths, the measuring tools, the
    #                                 bench, the fused frame program and
    #                                 the encoder's fused programs
    #                                 included
    assert {"thor_tpu_torch.enc.host", "thor_tpu_torch.enc.inter",
            "thor_tpu_torch.enc.quant", "thor_tpu_torch.ops.np_kernels",
            "thor_tpu_torch.utils.checkpoint",
            "thor_tpu_torch.dec.native_adapter",
            "thor_tpu_torch.dec.syntax_inputs",
            "thor_tpu_torch.dec.reconstruct_np",
            "thor_tpu_torch.ops.temporal_interp",
            "thor_tpu_torch.parallel.mesh", "thor_tpu_torch.parallel.stream",
            "thor_tpu_torch.parallel.encode",
            "thor_tpu_torch.parallel.worker",
            "thor_tpu_torch.utils.tracing", "thor_tpu_torch.utils.synth",
            "thor_tpu_torch.utils.device_decode_fps",
            "thor_tpu_torch.utils.device_encode_fps",
            "thor_tpu_torch.utils.scaling_curve",
            "thor_tpu_torch.utils.encode_scaling",
            "thor_tpu_torch.utils.encode_4k",
            "thor_tpu_torch.utils.link_profile",
            "thor_tpu_torch.bench", "thor_tpu_torch.dec.fused",
            "thor_tpu_torch.enc.fused"} <= set(out)


def test_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode_file(str(TESTDATA / "intra_only.bit"))
    with pytest.raises(RuntimeError):
        Decoder()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Encoder(EncoderParams(width=64, height=64, device_encode=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Encoder(EncoderParams(width=64, height=64))     # the host mirror
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedDecoder()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedEncoder(EncoderParams(width=64, height=64, device_encode=1))
    for tool in (device_decode_fps.measure, scaling_curve.measure,
                 encode_4k.measure):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tool()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_encode_fps.measure([], device_encode_fps.LDB_1080)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        encode_scaling.measure()
    cfg = tmp_path / "enc.cfg"
    cfg.write_text("-device_encode 1 -intra_period 1\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        encode_file(str(cfg), str(TESTDATA / "test_cif.yuv"),
                    str(tmp_path / "o.bit"), 352, 288, 1)
    assert Encoder(EncoderParams(width=64, height=64, device_encode=1),
                   device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_bench_and_link_profile_raise_without_a_card():
    """The bench's children and link_profile.measure_link, called without
    a device, refuse to run on the CPU in its place."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        link_profile.measure_link(1920 * 1080 * 3 // 2)
    for child in bench.CHILD_FNS.values():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            child()
