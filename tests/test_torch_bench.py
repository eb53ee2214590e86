"""``python -m sparsetpu_torch.bench``, the port's headline line (the
counterpart of the repository's ``bench.py``), on the CPU.

The entry runs in a subprocess with JAX blocked, as on the card's machine,
which has no JAX: ``--device cpu --small`` prints exactly one JSON line
with ``bench.py``'s keys; ``--device cuda`` without a card prints
``bench.py``'s error line and exits 1.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from sparsetpu_torch.bench.__main__ import main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "roofline_frac",
              "fill", "backend", "layout"}

_JAX_BLOCKED = r"""
import runpy, sys
sys.modules["jax"] = None          # any jax import now fails
sys.argv = ["sparsetpu_torch.bench"] + sys.argv[1:]
runpy.run_module("sparsetpu_torch.bench", run_name="__main__")
"""


def _run(*argv):
    return subprocess.run([sys.executable, "-c", _JAX_BLOCKED, *argv],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)


def test_cpu_small_prints_one_line_with_jax_blocked():
    out = _run("--device", "cpu", "--small")
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert BENCH_KEYS | {"stream_ms", "call_ms", "card",
                         "verify_errors"} == set(line)
    assert line["metric"] == "spmv_throughput" and line["unit"] == "Gnnz/s"
    assert line["value"] > 0 and line["backend"] == "cpu"
    assert line["verify_errors"] == 0 and line["call_ms"] > 0
    assert line["layout"]["final"] == "fused-instep"
    assert line["roofline_frac"] is None and line["stream_ms"] is None


def test_cuda_without_a_card_prints_the_error_line(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert main(["--device", "cuda"]) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    line = json.loads(lines[-1])
    assert len(lines) == 1 and line["backend"] == "error"
    assert line["value"] == 0.0 and "is_available" in line["error"]
    assert BENCH_KEYS - {"roofline_frac", "fill", "layout"} < set(line)


def test_small_is_for_the_cpu():
    with pytest.raises(SystemExit) as e:
        main(["--small"])
    assert e.value.code == 2
