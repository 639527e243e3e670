"""The command refuses to run without a card, and without the program."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import pytest

from portbench import spec


def _run(cwd, env=None):
    cmd = [sys.executable, "-m", "portbench", "--workload", "c2-lloyd", "--seed",
           str(2 ** 33 + 1), "--seconds", "1", "--trace", "0"]
    return subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=120)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    got = _run(spec.ROOT, env)
    assert got.returncode != 0
    assert not got.stdout.strip()
    assert "CUDA card" in got.stderr


def test_a_checkout_of_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    got = _run(tmp_path, dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert got.returncode != 0 and not got.stdout.strip()


@pytest.mark.chip
def test_a_short_run_on_the_card(card):
    got = subprocess.run([sys.executable, "-m", "portbench", "--workload", "c2-lloyd", "--seed",
                          str(2 ** 33 + 2), "--seconds", "2", "--trace", "0"], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert got.returncode == 0, got.stderr[-2000:]
    assert '"correct": true' in got.stdout.strip().splitlines()[-1]
