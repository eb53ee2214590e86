"""sparsetpu_torch's SuiteSparse suite (``bench/suite.py``) on the CPU,
against the JAX package's ``run_suite``.

  real        a small matrix pre-placed in a temporary cache under a suite
              name (uniform rows, and power-law rows, which take the
              heavy-row hybrid): the row is ``real`` and PASS (the kernels'
              plain versions, y against the gold), with the JAX row's keys;
              the JAX row is built by the JAX ``run_suite`` from the port's
              measurement (its ``fetch`` and ``bench_spmv`` stubbed: the
              JAX ``fetch`` downloads), so the two rows agree key by key;
  skip        a suite matrix missing from the cache, with no mirror to
              download from and without ``--synthetic``: the row is
              ``skip``, the error the port's ``fetch`` raises
              (ConnectionError, as the JAX ``fetch``) its reason;
  structured  ``_structured_suite``'s names, and each generator's matrix,
              equal the JAX package's.
"""

import dataclasses
import json

import numpy as np
import pytest

from sparsetpu.bench import harness as jharness
from sparsetpu.bench import suite as jsuite
from sparsetpu.formats import suitesparse as jss
from sparsetpu.formats.csr import CSRMatrix as JaxCSRMatrix

from sparsetpu_torch import _host
from sparsetpu_torch.bench import suite
from sparsetpu_torch.formats import suitesparse as pss
from sparsetpu_torch.formats.io import write_matrix


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """An empty suite cache directory of the port's, and no mirror to
    download from (``fetch`` tries none)."""
    monkeypatch.setenv("SPARSETPU_TORCH_SS_DIR", str(tmp_path))
    monkeypatch.setattr(pss, "MIRRORS", ())
    assert pss.cache_dir() == str(tmp_path)
    return tmp_path


def _small(powerlaw=False):
    """A small matrix: uniform rows (the fused device), or power-law rows
    (the heavy-row hybrid: fused light rows, classic heavy rows)."""
    if powerlaw:
        return _host.random_csr(3000, 3000, density=0.002, seed=5,
                                dtype=np.float32, powerlaw=True)
    return _host.random_csr(400, 500, density=0.02, seed=8,
                            dtype=np.float32)


def _jax_row(name, m, port_result, monkeypatch):
    """The JAX ``run_suite`` row of ``name`` for the port's measurement of
    ``m``: its ``fetch`` gives ``m`` (real), its ``bench_spmv`` the port's
    numbers."""
    jm = JaxCSRMatrix(m.row_ptr, m.col_ind, m.values, m.nr_rows, m.nr_cols)
    monkeypatch.setattr(jss, "fetch", lambda name, allow_synthetic: (jm,
                                                                     True))
    monkeypatch.setattr(jharness, "bench_spmv", lambda *a, **k:
                        jharness.BenchResult(**dataclasses.asdict(
                            port_result)))
    [row] = jsuite.run_suite([name], verbose=False)
    return row


@pytest.mark.parametrize("name", ["scircuit", "webbase-1M"])
def test_a_preplaced_matrix_is_real_and_passes(name, cache, monkeypatch,
                                               capsys):
    """``webbase-1M``'s power-law rows take the hybrid, whose x stays
    unpacked: ``bench_spmv`` times the fused kernel of its light rows on
    that device's own packed x."""
    m = _small(powerlaw=name == "webbase-1M")
    write_matrix(str(cache / f"{name}.mtx"), m)
    results = []
    from sparsetpu_torch.bench import harness
    bench = harness.bench_spmv

    def keep(*a, **k):
        results.append(bench(*a, **k))
        return results[-1]
    monkeypatch.setattr(harness, "bench_spmv", keep)
    assert suite.main([name, "--json", "--device", "cpu"]) == 0
    [row] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["status"] == "real" and row["verify"] == "PASS"
    assert (row["rows"], row["cols"], row["nnz"]) == (m.nr_rows, m.nr_cols,
                                                      m.nr_nzeros)
    jrow = _jax_row(name, m, results[0], monkeypatch)
    assert list(row) == list(jrow) and list(row["layout"]) == \
        list(jrow["layout"])
    # the same measurement gives the same row (NaN: no roofline on the CPU)
    assert json.dumps(row) == json.dumps(jrow)


def test_a_missing_matrix_is_skipped(cache):
    [row] = suite.run_suite(["pwtk"], verbose=False, device="cpu")
    assert row["status"] == "skip" and "pwtk.mtx" in row["reason"]
    assert set(row) == {"matrix", "status", "reason"}
    with pytest.raises(ConnectionError, match="pwtk.mtx"):
        pss.fetch("pwtk")


def test_an_unknown_name_is_skipped(cache):
    [row] = suite.run_suite(["no-such-matrix"], verbose=False,
                            device="cpu")
    assert row["status"] == "skip" and "CLASSIC_SUITE" in row["reason"]


def test_structured_generators_match_jax():
    port, ref = suite._structured_suite(), jsuite._structured_suite()
    assert list(port) == list(ref)
    for name in port:
        a, b = port[name](), ref[name]()
        assert (a.nr_rows, a.nr_cols, a.nr_nzeros) == \
            (b.nr_rows, b.nr_cols, b.nr_nzeros), name
        for k in ("row_ptr", "col_ind", "values"):
            x, y = getattr(a, k), getattr(b, k)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), name
