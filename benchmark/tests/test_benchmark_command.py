"""The command's refusals: no card means no result and a non-zero exit,
and so does a directory that holds only BENCHMARK.json and the
benchmark's own files (the program is missing)."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "j1713-l64.stream",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env or {})))


def test_exits_nonzero_without_a_card():
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_exits_nonzero_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_unknown_workload_is_refused():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "no-such-cell",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_forbidden_names_are_whole_top_level_names():
    code = ("import sys; sys.path.insert(0, '.');"
            "from benchmark import harness;"
            "sys.modules['psrsigsim_tpu_like'] = sys;"
            "sys.modules['jaxlike.x'] = sys;"
            "print(harness.forbidden_modules());"
            "sys.modules['jax.numpy'] = sys;"
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    lines = out.stdout.strip().splitlines()
    assert lines == ["[]", "['jax']"]


def test_nothing_the_benchmark_loads_is_jax_or_the_jax_package():
    """Import every module of the benchmark and every program module its
    drivers reach, then look at sys.modules by whole top-level names; the
    reference imports nothing of the program."""
    code = r"""
import importlib, json, pkgutil, sys
sys.path.insert(0, '.')
import benchmark.reference.keys, benchmark.reference.philox
import benchmark.reference.fold, benchmark.reference.observations
ref_only = sorted(m for m in sys.modules
                  if m.split('.')[0] == 'psrsigsim_torch')
import benchmark, benchmark.harness as h
for m in pkgutil.iter_modules(benchmark.__path__):
    importlib.import_module('benchmark.' + m.name)
import benchmark.drivers as d
for m in pkgutil.iter_modules(d.__path__):
    importlib.import_module('benchmark.drivers.' + m.name)
spec = h.load_spec()
for m in spec['per_layer']:
    h.load_reader(m['name'])
import psrsigsim_torch.parallel, psrsigsim_torch.mc
import psrsigsim_torch.runtime.telemetry, psrsigsim_torch.simulate
print(json.dumps({'ref': ref_only, 'bad': h.forbidden_modules()}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"ref": [], "bad": []}
