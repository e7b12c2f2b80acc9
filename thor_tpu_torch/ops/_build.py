"""Build and load the port's native libraries at first use.

CUDA kernels: every `csrc/<name>.cu` is compiled by nvcc for sm_90a into
its own shared library with a plain C interface and loaded with ctypes.
All sources build at once, one nvcc process each, started together. The
C entropy parser (native/thor_entropy.c) builds the same way with gcc.

Outputs go to the package's `_build/` directory (listed in .gitignore),
named by a hash of the source, the shared headers (csrc/*.cuh) and the
flags, so an edited source or header rebuilds and concurrent processes
never load a half-written file (each compiles to a private temporary
name and renames it into place).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = PKG / "_build"
CSRC = PKG / "csrc"

CUDA_SOURCES = ("mc", "intra_scan", "interp_me", "interp_mc",
                "enc_intra_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GCC_FLAGS = ("-O2", "-shared", "-fPIC")

# name -> compiler output of this process's builds (nvcc's -Xptxas -v
# register / shared-memory report); empty when the library was cached.
BUILD_LOG: dict = {}
_cuda_libs: dict = {}


def _target(name: str, src: Path, flags) -> Path:
    h = hashlib.sha256(src.read_bytes())
    if src.suffix == ".cu":         # the headers a kernel source may include
        for hdr in sorted(CSRC.glob("*.cuh")):
            h.update(hdr.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_shared(jobs):
    """jobs: [(name, compiler argv prefix, source, flags)]. Compiles every
    missing library concurrently; returns {name: path}. Raises with the
    compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, running = {}, []
    for name, cc, src, flags in jobs:
        so = _target(name, src, flags)
        out[name] = so
        if so.exists():
            BUILD_LOG.setdefault(name, "")
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            list(cc) + list(flags) + ["-o", str(tmp), str(src)]
            + (["-lm"] if src.suffix == ".c" else []),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, proc, tmp, so))
    failed = []
    for name, proc, tmp, so in running:
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("native build failed\n" + "\n".join(failed))
    return out


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(path).exists():
        raise RuntimeError("nvcc not found; the CUDA kernels build only "
                           "on a machine with the CUDA toolkit")
    return path


def cuda_library(name: str) -> ctypes.CDLL:
    """The CDLL for csrc/<name>.cu. The first call builds every CUDA
    source (in parallel) so one process pays for one build round."""
    if name not in _cuda_libs:
        paths = build_shared([(n, (nvcc(),), CSRC / f"{n}.cu", NVCC_FLAGS)
                              for n in CUDA_SOURCES])
        for n, p in paths.items():
            _cuda_libs[n] = ctypes.CDLL(str(p))
    return _cuda_libs[name]
