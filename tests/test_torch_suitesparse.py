"""sparsetpu_torch's SuiteSparse module (``formats/suitesparse.py``) against
the JAX package's (``sparsetpu/formats/suitesparse.py``).

The registry and the synthetic stand-ins are byte-identical to the JAX
package's (the crc32 seed of its ``:164-180``), for the power-law
webbase-1M and one general matrix.  ``fetch`` reads a ``.mtx`` already in
the port's own cache directory; with none it downloads it (``download``)
from ``MIRRORS``: here a local HTTP server on 127.0.0.1 that serves a
tarball built in the test, against the JAX ``download`` from the same
server; with no mirror it raises, or returns the stand-in under
``allow_synthetic``, and opens no socket.  No test reaches the network.
"""

import contextlib
import dataclasses
import functools
import http.server
import os
import socket
import tarfile
import threading

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
    """An empty cache directory of the port's own, and no mirror to
    download from."""
    monkeypatch.setenv("SPARSETPU_TORCH_SS_DIR", str(tmp_path))
    monkeypatch.setattr(ss, "MIRRORS", ())
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
    with pytest.raises(ConnectionError, match="rma10.mtx"):
        ss.fetch("rma10")
    m, real = ss.fetch("rma10", allow_synthetic=True)
    assert real is False
    _same(m, ss.synthetic_stand_in("rma10"))
    with pytest.raises(KeyError, match="pass group"):
        ss.fetch("nosuchmatrix", allow_synthetic=True)
    with pytest.raises(ConnectionError):
        ss.fetch("nosuchmatrix", group="Nobody", allow_synthetic=True)


def test_fetch_has_no_network_path(cache, no_network):
    """With ``MIRRORS`` empty nothing is tried: the download of a missing
    matrix raises at once, opens no socket and leaves the cache empty."""
    with pytest.raises(ConnectionError, match="every mirror"):
        ss.download("Boeing", "pwtk")
    assert list(cache.iterdir()) == []


@contextlib.contextmanager
def _mirror(root):
    """An HTTP server on 127.0.0.1 serving the directory ``root``; yields
    its URL."""
    handler = functools.partial(http.server.SimpleHTTPRequestHandler,
                                directory=str(root))
    handler.log_message = lambda *a: None
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join()


def test_fetch_downloads_from_a_mirror(tmp_path, monkeypatch):
    """A matrix not in the cache is downloaded from the first mirror that
    serves it (the first here answers 404), its tarball kept and its
    ``.mtx`` extracted as the JAX ``download`` does from the same server;
    then read from the cache, the server gone."""
    for var in ("http_proxy", "https_proxy", "all_proxy", "HTTP_PROXY",
                "HTTPS_PROXY", "ALL_PROXY"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("no_proxy", "*")
    monkeypatch.setenv("NO_PROXY", "*")
    m = random_csr(300, 200, density=0.02, seed=4)
    serve = tmp_path / "serve"
    (serve / "MM" / "Boeing").mkdir(parents=True)
    write_matrix(str(tmp_path / "cant.mtx"), m)
    with tarfile.open(serve / "MM" / "Boeing" / "cant.tar.gz", "w:gz") as tf:
        tf.add(tmp_path / "cant.mtx", arcname="cant/cant.mtx")
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    monkeypatch.setenv("SPARSETPU_TORCH_SS_DIR", str(port_dir))
    monkeypatch.setenv("SPARSETPU_SS_DIR", str(jax_dir))
    with _mirror(serve) as url:
        mirrors = (url + "/none/{group}/{name}.tar.gz",
                   url + "/MM/{group}/{name}.tar.gz")
        monkeypatch.setattr(ss, "MIRRORS", mirrors)
        monkeypatch.setattr(jss, "MIRRORS", mirrors)
        got, real = ss.fetch("cant", group="Boeing")
        jpath = jss.download("Boeing", "cant")
    assert real is True
    _same(got, read_matrix(str(tmp_path / "cant.mtx")))
    files = sorted(os.path.relpath(os.path.join(r, f), port_dir)
                   for r, _, fs in os.walk(port_dir) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(r, f), jax_dir)
                           for r, _, fs in os.walk(jax_dir) for f in fs)
    assert files == ["cant.tar.gz", os.path.join("cant", "cant.mtx")]
    with open(port_dir / "cant" / "cant.mtx", "rb") as a, \
            open(jpath, "rb") as b:
        assert a.read() == b.read()
    monkeypatch.setattr(ss, "MIRRORS", ())
    again, real = ss.fetch("cant")
    assert real is True
    _same(again, got)


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
