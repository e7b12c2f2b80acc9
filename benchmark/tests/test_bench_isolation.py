"""What the benchmark loads and what it does without a card."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys


from benchmark.tests.rehearsal import BENCH, REPO

FORBIDDEN = ("jax", "jaxlib", "flax", "thor_tpu")


def _modules_under_benchmark():
    mods = []
    for p in sorted(BENCH.rglob("*.py")):
        rel = p.relative_to(REPO).with_suffix("")
        if ".cache" in rel.parts or "tests" in rel.parts:
            continue
        if "." in rel.name:
            continue                # metric readers: loaded by file
        mods.append(".".join(rel.parts).removesuffix(".__init__"))
    return mods


def test_imports_load_no_jax_and_no_thor_tpu():
    """Importing benchmark.run, every module under benchmark/, every
    metric reader and the port's entry points loads no module whose
    top-level name, compared whole, is jax, jaxlib, flax or thor_tpu."""
    code = (
        "import importlib, json, sys\n"
        f"mods = {_modules_under_benchmark()!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "from benchmark import harness\n"
        "spec = harness.benchmark_spec()\n"
        "for m in spec['per_layer']: harness.metric_reader(m['name'])\n"
        "import thor_tpu_torch.enc.encoder\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "benchmark.run" in loaded
    assert "thor_tpu_torch" in loaded
    bad = [m for m in loaded if m.split(".")[0] in FORBIDDEN]
    assert bad == []
    # nor the program's own measuring scripts
    assert not {"bench", "chip_smoke", "thor_tpu_torch.bench"} & set(loaded)


def _run(cwd, env=None, workload="ldb_1080.enc"):
    e = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env or {}))
    return subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", workload,
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=e, capture_output=True, text=True, timeout=300)


def test_a_measurement_run_without_a_card_exits_non_zero():
    out = _run(REPO)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_the_benchmark_alone_exits_non_zero(tmp_path):
    """A directory that holds only BENCHMARK.json and benchmark/ cannot
    run a cell (it has no program)."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
