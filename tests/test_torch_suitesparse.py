"""sparsetpu_torch's SuiteSparse module (``formats/suitesparse.py``) against
the JAX package's (``sparsetpu/formats/suitesparse.py``).

The registry and the synthetic stand-ins are byte-identical to the JAX
package's (the crc32 seed of its ``:164-180``), for the power-law
webbase-1M and one general matrix.  ``fetch`` reads only a ``.mtx``
already in the port's own cache directory; with none it raises, or
returns the stand-in under ``allow_synthetic``; it opens no socket.
"""

import dataclasses
import inspect
import socket

import numpy as np
import pytest

from sparsetpu.formats import suitesparse as jss
from sparsetpu_torch.formats import suitesparse as ss
from sparsetpu_torch.formats.io import read_matrix, write_matrix
from sparsetpu_torch.formats.random import random_csr


def _same(a, b):
    assert (a.nr_rows, a.nr_cols, a.nr_nzeros) == (b.nr_rows, b.nr_cols,
                                                   b.nr_nzeros)
    for k in ("row_ptr", "col_ind", "values"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and np.array_equal(x, y), k


def test_classic_suite_is_the_jax_registry():
    assert list(ss.CLASSIC_SUITE) == list(jss.CLASSIC_SUITE)
    for name, info in ss.CLASSIC_SUITE.items():
        assert dataclasses.astuple(info) == dataclasses.astuple(
            jss.CLASSIC_SUITE[name]), name


@pytest.mark.parametrize("name", ["webbase-1M", "rma10"])
def test_stand_in_is_byte_identical_to_jax(name):
    m = ss.synthetic_stand_in(name)
    _same(m, jss.synthetic_stand_in(name))
    info = ss.CLASSIC_SUITE[name]
    assert (m.nr_rows, m.nr_cols) == (info.rows, info.cols)


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """An empty cache directory of the port's own."""
    monkeypatch.setenv("SPARSETPU_TORCH_SS_DIR", str(tmp_path))
    return tmp_path


@pytest.fixture
def no_network(monkeypatch):
    """Any socket the test opens raises."""
    def refuse(*args, **kwargs):
        raise AssertionError("fetch opened a socket")
    monkeypatch.setattr(socket, "socket", refuse)
    monkeypatch.setattr(socket, "create_connection", refuse)


@pytest.mark.parametrize("nested", [False, True])
def test_fetch_reads_a_placed_mtx(cache, no_network, nested):
    m = random_csr(300, 200, density=0.02, seed=4)
    d = cache / "cant" if nested else cache
    d.mkdir(exist_ok=True)
    write_matrix(str(d / "cant.mtx"), m)
    got, real = ss.fetch("cant")
    assert real is True
    _same(got, read_matrix(str(d / "cant.mtx")))
    write_matrix(str(cache / "mine.mtx"), m)
    got, real = ss.fetch("mine", group="Mine")
    assert real is True and got.nr_nzeros == m.nr_nzeros


def test_fetch_with_an_empty_cache(cache, no_network):
    with pytest.raises(FileNotFoundError, match="rma10.mtx"):
        ss.fetch("rma10")
    m, real = ss.fetch("rma10", allow_synthetic=True)
    assert real is False
    _same(m, ss.synthetic_stand_in("rma10"))
    with pytest.raises(KeyError, match="pass group"):
        ss.fetch("nosuchmatrix", allow_synthetic=True)
    with pytest.raises(FileNotFoundError):
        ss.fetch("nosuchmatrix", group="Nobody", allow_synthetic=True)


def test_fetch_has_no_network_path():
    src = inspect.getsource(ss)
    for word in ("urllib", "socket", "http", "download", "MIRRORS"):
        assert word not in src, word


def test_cache_dir_is_the_ports_own(monkeypatch, tmp_path):
    for var in ("SPARSETPU_TORCH_SS_DIR", "SPARSETPU_TORCH_CACHE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("SPARSETPU_SS_DIR", str(tmp_path / "jax"))
    monkeypatch.setenv("SPARSETPU_CACHE", str(tmp_path / "jaxc"))
    monkeypatch.setenv("HOME", str(tmp_path))
    assert ss.cache_dir() == str(tmp_path / ".cache" / "sparsetpu_torch"
                                 / "suitesparse")
    monkeypatch.setenv("SPARSETPU_TORCH_CACHE", str(tmp_path / "c"))
    assert ss.cache_dir() == str(tmp_path / "c" / "suitesparse")
    monkeypatch.setenv("SPARSETPU_TORCH_SS_DIR", str(tmp_path / "ss"))
    assert ss.cache_dir() == str(tmp_path / "ss")
