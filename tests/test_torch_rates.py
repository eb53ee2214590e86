"""sparsetpu_torch's rate sweep (``pack/rates.py``) against the JAX
package's ``refresh_rates`` recipe and layout chooser.

  inputs    ``rate_inputs`` against a transcription of
            ``sparsetpu/pack/rates.py:133-151``;
  kernel    the port's forward (#3) on the CPU against the JAX
            ``_spmv_kernel`` in ``pl.pallas_call(..., interpret=True)``,
            built as ``rates.py:155-174``, at atol 1e-5 * max(1, max|y|);
  sweep     ``refresh_rates`` with a stub timer: keys, values, the cache;
  chooser   ``_choose_layout(m, rates=T)`` against the JAX chooser with T
            in its cache, and the default packs byte-identical to the JAX
            package's with a port cache on disk.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import sparsetpu.pack.gather_stream as jax_gs
import sparsetpu.pack.rates as jax_rates
from sparsetpu.formats.csr import CSRMatrix as JaxCSRMatrix
from sparsetpu.kernels.spmv_pallas import _spmv_kernel

from sparsetpu_torch import _host
from sparsetpu_torch.kernels import spmv_gstream as sg
from sparsetpu_torch.pack import gather_stream as port_gs
from sparsetpu_torch.pack import rates
from test_torch_fused import native_engines_first  # noqa: F401 (autouse)

N_TILES = 16


def _recipe(gs, n_tiles):
    """``sparsetpu/pack/rates.py:133-151``, transcribed."""
    rng = np.random.default_rng(0)
    rows = n_tiles * 8
    val = rng.standard_normal((rows, 128)).astype(np.float32)
    route = rng.integers(0, 128, size=(rows, 128)).astype(np.int32)
    xw0 = rng.standard_normal((8 * 32, 128)).astype(np.float32)
    metas = {}
    for G in gs:
        if G not in metas:
            cells = rng.integers(0, 8 * G, size=(rows, 128))
            metas[G] = ((cells << 7) | route).astype(np.int16)
    return val, xw0, metas


@pytest.mark.parametrize("gs", [2, [2, 8, 2, 1], [1, 2, 4, 8, 16, 32]])
def test_rate_inputs_follow_the_jax_recipe(gs):
    val, xw0, metas = rates.rate_inputs(gs, N_TILES)
    rv, rx, rm = _recipe([gs] if isinstance(gs, int) else gs, N_TILES)
    assert np.array_equal(val, rv) and np.array_equal(xw0, rx)
    assert list(metas) == list(rm)
    for g in rm:
        assert metas[g].dtype == np.int16 and np.array_equal(metas[g], rm[g])


@pytest.mark.parametrize("G,Q", [(2, 8), (8, 2)])
def test_forward_matches_jax_kernel_at_rate_inputs(G, Q):
    val, xw0, metas = rates.rate_inputs(G, N_TILES)
    T, P = min(128, N_TILES), 8 // Q

    def kern(xw, v, m, o):
        _spmv_kernel(None, xw, v, m, o, tiles_per_step=T, G=G, P=P)
    f = pl.pallas_call(
        kern,
        grid_spec=pl.GridSpec(
            grid=(N_TILES // T,),
            in_specs=[pl.BlockSpec((8 * 32, 128), lambda i: (0, 0)),
                      pl.BlockSpec((T * 8, 128), lambda i: (i, 0)),
                      pl.BlockSpec((T * 8, 128), lambda i: (i, 0))],
            out_specs=pl.BlockSpec((T * P, 128), lambda i: (i, 0))),
        out_shape=jax.ShapeDtypeStruct((N_TILES * P, 128), jnp.float32),
        interpret=True)
    yj = np.asarray(f(jnp.asarray(xw0), jnp.asarray(val),
                      jnp.asarray(metas[G])))
    yt = sg.gstream_chunk_sums(
        torch.from_numpy(val), torch.from_numpy(metas[G]),
        torch.zeros(N_TILES // T, dtype=torch.int32), torch.from_numpy(xw0),
        T=T, G=G, P=P).numpy()
    atol = 1e-5 * max(1.0, float(np.abs(yj).max()))
    np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=atol)


def test_refresh_rates_with_a_stub_timer(tmp_path, monkeypatch):
    monkeypatch.setenv("SPARSETPU_TORCH_CACHE", str(tmp_path))
    combos = [(2, 8), (8, 2), (1, 1)]
    shapes, ms = [], iter([0.5, 1.0, 2.0])

    def timer(fn, dev):
        assert dev == torch.device("cpu")
        shapes.append(tuple(fn().shape))
        return next(ms)
    t = rates.refresh_rates(device="cpu", combos=combos, n_tiles=N_TILES,
                            timer=timer)
    assert list(t) == combos
    assert shapes == [(N_TILES * 8 // q, 128) for _, q in combos]
    for (combo, v), m in zip(t.items(), (0.5, 1.0, 2.0)):
        assert v == pytest.approx(N_TILES * 1024 / (m * 1e-3) / 1e9)


def test_refresh_rates_needs_a_timer_on_the_cpu():
    with pytest.raises(ValueError, match="CPU times are not"):
        rates.refresh_rates(device="cpu", combos=[(2, 8)], n_tiles=N_TILES)
    with pytest.raises(ValueError, match="multiple of"):
        rates.refresh_rates(device="cpu", combos=[(2, 8)], n_tiles=200,
                            timer=lambda fn, dev: 1.0)


def test_cache_round_trip(tmp_path, monkeypatch):
    monkeypatch.setenv("SPARSETPU_TORCH_CACHE", str(tmp_path / "c"))
    assert rates.load_rates("cpu") is None
    t = rates.refresh_rates(device="cpu", n_tiles=N_TILES,
                            timer=lambda fn, dev: 0.25)
    assert set(t) == set(rates.RATE_COMBOS) and len(t) == 24
    assert rates.load_rates("cpu") == t
    assert (tmp_path / "c" / "rates_cpu.json").exists()
    card = "NVIDIA H100 80GB HBM3"
    assert rates._cache_path(card).endswith("rates_NVIDIA_H100_80GB_HBM3.json")
    assert rates.load_rates(card) is None


def _favour(g, q):
    """A table that makes (g, q) far faster than every other layout."""
    return {k: (1000.0 if k == (g, q) else 10.0) for k in rates.RATE_COMBOS}


@pytest.mark.parametrize("shape,seed,fav", [
    ((3000, 20_000, 0.002), 7, (16, 2)),
    ((4000, 60_000, 0.0005), 3, (4, 8))])
def test_choose_layout_with_a_table_matches_jax_with_it_cached(
        tmp_path, monkeypatch, shape, seed, fav):
    m = _host.random_csr(shape[0], shape[1], density=shape[2], seed=seed,
                         dtype=np.float32)
    jm = JaxCSRMatrix(m.row_ptr, m.col_ind, m.values, m.nr_rows, m.nr_cols)
    table = _favour(*fav)
    monkeypatch.setenv("SPARSETPU_CACHE", str(tmp_path))
    monkeypatch.setattr(jax_rates, "_loaded", {})
    with open(tmp_path / "rates_cpu.json", "w") as f:
        json.dump({f"{g},{q}": v for (g, q), v in table.items()}, f)
    assert jax_rates._device_kind() == "cpu"
    pick = port_gs._choose_layout(m, rates=table)
    assert pick == jax_gs._choose_layout(jm) == fav
    assert pick != port_gs._choose_layout(m)


def test_default_pack_unchanged_with_a_port_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("SPARSETPU_TORCH_CACHE", str(tmp_path))
    for kind in ("cpu", "NVIDIA H100 80GB HBM3"):
        with open(rates._cache_path(kind), "w") as f:
            json.dump({f"{g},{q}": v for (g, q), v in
                       _favour(16, 2).items()}, f)
    m = _host.random_csr(3000, 20_000, density=0.002, seed=7,
                         dtype=np.float32)
    jm = JaxCSRMatrix(m.row_ptr, m.col_ind, m.values, m.nr_rows, m.nr_cols)
    p, jp = _host.pack_gstream(m), jax_gs.pack_gstream(jm)
    assert (p.G, p.Q) == (jp.G, jp.Q) != (16, 2)
    for k in ("values", "cell_idx", "route", "chunk_row", "step_window"):
        a, b = getattr(p, k), getattr(jp, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    q = _host.pack_gstream(m, rates=_favour(16, 2))
    assert (q.G, q.Q) == (16, 2)


def test_slot_rate_takes_the_table_and_its_nearest_g():
    t = {(1, 8): 5.0, (4, 8): 7.0, (2, 4): 9.0}
    assert rates.slot_rate(4, 8, rates=t) == 7.0
    assert rates.slot_rate(2, 8, rates=t) == 5.0       # the nearest G
    assert rates.slot_rate(3, 8, rates=t) == 7.0
    assert rates.slot_rate(8, 1, rates=t) == 80.0      # no G at this Q
    assert rates.slot_rate(32, 8) == jax_rates._V5E_RATES[(32, 8)]
