"""Without a GPU, or without the program, a run prints no result and exits
with a non-zero code: it never falls back to the CPU."""

import shutil
import subprocess
import sys

import pytest
import torch

from pb_core import program, spec

ARGS = ["--workload", "cover.render", "--seed", "3", "--seconds", "1", "--trace", "0"]


def _run(cwd):
    return subprocess.run([sys.executable, "port_bench/run.py", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_no_gpu_no_result():
    if torch.cuda.is_available():
        pytest.skip("a GPU is here: the run would measure")
    out = _run(spec.ROOT)
    assert out.returncode != 0
    assert not [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert "cuda" in out.stderr.lower()


def test_benchmark_alone_has_no_program(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.BENCH_DIR, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with pytest.raises(program.ProgramMissing):
        program.load(tmp_path)
    out = _run(tmp_path)
    assert out.returncode != 0
    assert not [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
