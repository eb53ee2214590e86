"""The harness on the CPU at small sizes: discovery by file, the
comparison's faults and control, the byte counts, the import check, and
the refusals (no card; no port beside the benchmark)."""

import ast
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

import sparsetpu_torch as port
from sparsetpu_torch import solvers
from spbench import harness, roofline
from spbench.control import control_readings
from spbench.imports import forbidden_loaded

REPO = os.path.dirname(harness.ROOT)


def _run(root, cell, seconds=0.3, seed=2 ** 31 + 11):
    return harness.run_cell(cell, seed, seconds, False, time.perf_counter(),
                            device="cpu", root=str(root))


@pytest.mark.parametrize("cell", ["urand9.spmv", "hpcg6.spmv", "hpcg6.cg"])
def test_sound_run_is_correct(small_root, cell):
    r = _run(small_root, cell)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]
    assert "setup_s" in r["metrics"]
    e2e = {"spmv_gnnz_s"} if cell.endswith("spmv") else {"cg_set_ms"}
    assert set(r["metrics"]) == e2e | {"setup_s"}


def _alter_one(y):
    y = y.clone()
    y[y.shape[0] // 3] += 1.0
    return y


def _half_rows(y):
    y = y.clone()
    y[y.shape[0] // 2:] = 0.0
    return y


SPMV_FAULTS = {
    "answer_altered": lambda real: lambda self, x: _alter_one(real(self, x)),
    "half_left_out": lambda real: lambda self, x: _half_rows(real(self, x)),
}


@pytest.mark.parametrize("fault", [*SPMV_FAULTS, "state_unchanged"])
@pytest.mark.parametrize("cell", ["urand9.spmv", "hpcg6.spmv"])
def test_spmv_faults_fail(small_root, monkeypatch, cell, fault):
    real = port.SparseMatrix.__matmul__
    if fault == "state_unchanged":
        first = {}

        def stale(self, x):     # every call answers the first call's y
            if "y" not in first:
                first["y"] = real(self, x)
            return first["y"]
        broken = stale
    else:
        broken = SPMV_FAULTS[fault](real)
    monkeypatch.setattr(port.SparseMatrix, "__matmul__", broken)
    r = _run(small_root, cell)
    assert r["correct"] is False and r["failed"] > 0


def _pcg_state_unchanged(spmv, b, m_inv, x0=None, tol=0.0, maxiter=50,
                         **kw):
    return solvers.CGResult(torch.zeros_like(b), maxiter,
                            torch.linalg.norm(b).float())


@pytest.mark.parametrize("fault", ["state_unchanged", "answer_altered",
                                   "half_left_out", "iterations_cut"])
def test_cg_faults_fail(small_root, monkeypatch, fault):
    real = solvers.pcg_df64
    if fault == "state_unchanged":
        monkeypatch.setattr(solvers, "pcg_df64", _pcg_state_unchanged)
    elif fault == "answer_altered":
        def altered(*a, **kw):
            res = real(*a, **kw)
            return res._replace(x=_alter_one(res.x))
        monkeypatch.setattr(solvers, "pcg_df64", altered)
    elif fault == "half_left_out":
        spmv = port.SparseMatrix.spmv
        monkeypatch.setattr(port.SparseMatrix, "spmv",
                            lambda self, x: _half_rows(spmv(self, x)))
    else:
        def cut(*a, maxiter=50, **kw):
            return real(*a, maxiter=maxiter - 1, **kw)
        monkeypatch.setattr(solvers, "pcg_df64", cut)
    r = _run(small_root, "hpcg6.cg")
    assert r["correct"] is False and r["failed"] > 0


@pytest.mark.parametrize("cell", ["urand9.spmv", "hpcg6.spmv", "hpcg6.cg"])
def test_control_fails(small_root, cell):
    """The reference in the real type below the configuration's, in the
    program's place, fails the cell's comparison at every limit set."""
    readings = control_readings(cell, 2 ** 31 + 17, str(small_root))
    assert any(v > lim for v, lim in readings.values())


def test_csr_bytes():
    # urand20 at seed 0 of GAP's sizes; hpcg104
    assert roofline.csr_spmv_bytes(1 << 20, 1 << 20, 33553856, 4) == \
        281013764
    assert roofline.csr_spmv_bytes(1124864, 1124864, 29791000, 8) == \
        379989284
    assert roofline.csr_spmv_bytes(3, 5, 7, 8) == 7 * 12 + 4 * 4 + 5 * 8 \
        + 3 * 8
    assert roofline.hbm_gbps("NVIDIA H100 80GB HBM3") == 3350.0
    with pytest.raises(KeyError):
        roofline.hbm_gbps("cpu")


def test_new_config_cell_metric_by_files_alone(small_root):
    """A configuration, a cell and a per-layer metric added as files are
    taken up with no edit to the harness."""
    cfg = harness.load_json("configs", "hpcg6", str(small_root))
    cfg.update(name="hpcg4", nx=4, ny=4, nz=4)
    (small_root / "configs" / "hpcg4.json").write_text(json.dumps(cfg))
    (small_root / "workloads" / "hpcg4.spmv.json").write_text(json.dumps(
        {"config": "hpcg4", "traffic": "spmv_stream", "chips": 1,
         "limits": {"spmv_err": 1e-13}}))
    (small_root / "metrics" / "rows_seen.py").write_text(
        'KIND, UNIT = "end_to_end", "rows"\n\n\n'
        'def read(run):\n    return run.nr_rows\n')
    r = _run(small_root, "hpcg4.spmv")
    assert r["correct"] is True
    assert r["metrics"]["rows_seen"] == {"value": 64.0, "unit": "rows"}
    assert "rows_seen" not in harness.metric_readers()


def test_import_check():
    assert forbidden_loaded({"sparsetpu_torch": 1, "sparsetpu_torch.api": 1,
                             "numpy": 1}) == []
    assert forbidden_loaded({"sparsetpu": 1, "sparsetpu.api": 1, "jax": 1,
                             "jaxlib.xla": 1, "flax.nn": 1,
                             "jaxtyping": 1}) == [
        "flax.nn", "jax", "jaxlib.xla", "sparsetpu", "sparsetpu.api"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_import_no_jax():
    """No file of the benchmark imports JAX, the JAX package or the port's
    bench; the reference imports nothing of the port."""
    for dirpath, _, files in os.walk(harness.ROOT):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            for mod in _imports(path):
                top = mod.split(".", 1)[0]
                assert top not in ("jax", "jaxlib", "flax", "sparsetpu"), \
                    (path, mod)
                assert not mod.startswith("sparsetpu_torch.bench"), \
                    (path, mod)
                if os.sep + "reference" + os.sep in path:
                    assert top != "sparsetpu_torch", (path, mod)


def test_run_modules_load_no_jax(small_root):
    """A whole CPU run, in a fresh process, leaves no forbidden module in
    sys.modules, nor the port's own bench."""
    code = ("import time, sys; from spbench import harness; "
            "from spbench.imports import forbidden_loaded; "
            f"harness.run_cell('hpcg6.cg', 1, 0.2, False, "
            f"time.perf_counter(), device='cpu', root={str(small_root)!r}); "
            "print(forbidden_loaded() + [m for m in sys.modules "
            "if m.startswith('sparsetpu_torch.bench')])")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _entry(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "spbench", "--workload", "hpcg104.spmv",
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={**os.environ, **(env or {})})


def test_refuses_without_card():
    out = _entry(REPO, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_refuses_without_the_port(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's folder."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.ROOT, tmp_path / "spbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {"PYTHONPATH": "", "CUDA_VISIBLE_DEVICES": ""}
    out = _entry(tmp_path, env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_json_agrees_with_files():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    readers = harness.metric_readers()
    for cfg in bench["configs"]:
        assert cfg["file"] == f"spbench/configs/{cfg['name']}.json"
        own = harness.load_json("configs", cfg["name"])
        assert own["source"] == cfg["source"]
        assert own["reduced"] == cfg["reduced"]
    for cell in bench["workloads"]:
        wl = harness.load_json("workloads", cell["name"])
        assert (wl["config"], wl["traffic"], wl["chips"]) == (
            cell["config"], cell["traffic"], cell["chips"])
    kinds = {"end_to_end": bench["end_to_end"],
             "per_layer": bench["per_layer"]}
    listed = set()
    for kind, metrics in kinds.items():
        for m in metrics:
            listed.add(m["name"])
            assert readers[m["name"]].KIND == kind, m["name"]
            assert readers[m["name"]].UNIT == m["unit"], m["name"]
    assert listed == set(readers)


def test_benchmark_json_form():
    """Names, units and lines within the forms the benchmark file keeps."""
    import re
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    entries = bench["configs"] + bench["workloads"] + bench["end_to_end"] \
        + bench["per_layer"]
    for e in entries:
        assert name.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                    and "\t" not in e[key], (e["name"], key)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert unit.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    assert 1 <= bench["run_seconds"] <= 51
