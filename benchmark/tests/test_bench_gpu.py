"""A short run of a real cell on the card, as the benchmark is run:
`python3 benchmark/run.py` in a process of its own. Skips without a
card (decided inside the test); on the card:

    python -m pytest benchmark/tests/test_bench_gpu.py -m gpu -q
"""
import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["ra1080_batch", "shvc_x2_live"])
def test_a_short_run_on_the_card_is_correct(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cp = subprocess.run(
        [sys.executable, os.path.join("benchmark", "run.py"), "--workload",
         workload, "--seed", str(2 ** 31 + 99), "--seconds", "3",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=1200)
    assert cp.returncode == 0, cp.stderr[-4000:]
    out = json.loads(cp.stdout.strip().splitlines()[-1])
    assert out["correct"], out
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    assert out["device"]["memory_peak_bytes"] > 0
    assert out["metrics"]["peak_mem_mib"]["value"] > 0


def test_without_a_card_the_cli_exits_2_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cp = subprocess.run(
        [sys.executable, os.path.join("benchmark", "run.py"), "--workload",
         "ra1080_batch", "--seed", "1", "--seconds", "1"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert cp.returncode == 2 and cp.stdout == ""
