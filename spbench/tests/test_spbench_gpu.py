"""Each cell through the entry point on the card, briefly, traced: the run
is correct and its line carries the cell's per-layer metrics.  Run on the
card with ``python -m pytest spbench/tests/test_spbench_gpu.py -m gpu``."""

import json
import os
import subprocess
import sys

import pytest
import torch

from spbench import harness

REPO = os.path.dirname(harness.ROOT)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark runs on the card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["urand20.spmv", "hpcg104.spmv",
                                  "hpcg104.cg"])
def test_cell_traced(card, cell):
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    out = subprocess.run(
        [sys.executable, "-m", "spbench", "--workload", cell, "--seed",
         str(2 ** 31 + 101), "--seconds", "2", "--trace", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    want = {m["name"] for m in bench["per_layer"]
            if cell in m.get("workloads", [cell])}
    assert want <= set(line["metrics"])
    dev = line["device"]
    assert dev["platform"] == "gpu" and 0 < dev["busy_s"] <= dev["window_s"]
    assert line["breakdown"]["device_ops"]
