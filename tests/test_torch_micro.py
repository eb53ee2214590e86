"""sparsetpu_torch's stage ladder (``bench/micro.py``) against the JAX
package's ladder (``sparsetpu/bench/micro.py``).

Each stage's plain version (``ladder_reference``, which the CUDA kernel
``csrc/micro_ladder.cu`` is held to on the card) against a numpy
transcription of the JAX stage body (``micro.py:133-224``), at atol 1e-5 *
max(1, max|y|): ``stream``, ``lane``, ``dual``, ``tilebase``, and
``window-G`` against ``chain-G`` (with cells in [0, 8G), and with cells
< 8, where both equal ``dual``).  ``bench_ladder`` on the CPU returns every
stage.
"""

import numpy as np
import pytest
import torch

from sparsetpu_torch.bench import micro

N_TILES, T = 24, 8


def _jax_body(stage, val, idx, cell, xw, bases, G=1):
    """The JAX ladder's stage bodies (``sparsetpu/bench/micro.py:133-224``),
    one tile at a time in numpy; ``chain`` is ``chain-G``."""
    n = val.shape[0] // 8
    out = np.zeros((n, 128), np.float32)
    scale = xw[0, 0]
    for t in range(n):
        sl = slice(8 * t, 8 * t + 8)
        v, j = val[sl], idx[sl].astype(np.int32)
        if stage == "stream":
            out[t] = np.sum(v, axis=0) * scale
            continue
        if stage == "lane":
            out[t] = np.sum(np.take_along_axis(v, j, axis=1), axis=0) * scale
            continue
        i1 = cell[sl].astype(np.int32)
        if stage == "dual":
            g1 = np.take_along_axis(xw[0:8], i1, axis=0)
        elif stage == "tilebase":
            b = bases[t]
            g1 = np.take_along_axis(xw[8 * b:8 * b + 8], i1 & 7, axis=0)
        else:
            sub, grp = i1 & 7, i1 >> 3
            g1 = np.zeros((8, 128), np.float32)
            for g in range(G):
                part = np.take_along_axis(xw[8 * g:8 * g + 8], sub, axis=0)
                g1 = np.where(grp == g, part, g1)
        g2 = np.take_along_axis(g1, j, axis=1)
        out[t] = np.sum(v * g2, axis=0)
    return out


def _close_to(y, ref):
    y, ref = np.asarray(y), np.asarray(ref)
    atol = 1e-5 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(y, ref, rtol=1e-5, atol=atol)


@pytest.fixture(scope="module")
def inp():
    return micro.ladder_inputs(N_TILES, (2, 8, 32), T, "cpu")


def _np(inp, *keys):
    return [inp[k].numpy() for k in keys]


@pytest.mark.parametrize("stage", ["stream", "lane", "dual", "tilebase"])
def test_stage_matches_the_jax_body(inp, stage):
    val, idx, cell, xw, base = _np(inp, "val", "idx", "cell", "xw", "base")
    ref = _jax_body(stage, val, idx, cell, xw, base)
    y = micro.ladder_reference(stage, inp["val"], inp["idx"], inp["cell"],
                               inp["xw"], inp["base"])
    _close_to(y.numpy(), ref)
    # the wrapper takes the plain version for CPU tensors
    _close_to(micro.ladder_stage(stage, inp["val"], inp["idx"], inp["cell"],
                                 inp["xw"], inp["base"]).numpy(), ref)


@pytest.mark.parametrize("stage", ["window", "window-smem"])
@pytest.mark.parametrize("G", [2, 8, 32])
def test_window_matches_the_jax_chain(inp, stage, G):
    val, idx, xw = _np(inp, "val", "idx", "xw")
    cells = inp["cells"][G]
    ref = _jax_body("chain", val, idx, cells.numpy(), xw, None, G)
    y = micro.ladder_stage(stage, inp["val"], inp["idx"], cells, inp["xw"],
                           G=G)
    _close_to(y.numpy(), ref)


@pytest.mark.parametrize("G", [1, 4, 32])
def test_window_with_cells_below_8_equals_dual(inp, G):
    """As chain-G does in the JAX ladder (its cells are < 8)."""
    val, idx, cell, xw = _np(inp, "val", "idx", "cell", "xw")
    dual = _jax_body("dual", val, idx, cell, xw, None)
    _close_to(_jax_body("chain", val, idx, cell, xw, None, G), dual)
    for stage in ("window", "window-smem"):
        y = micro.ladder_reference(stage, inp["val"], inp["idx"],
                                   inp["cell"], inp["xw"], G=G)
        _close_to(y.numpy(), dual)


def test_past_the_window_reads_zero(inp):
    """Cells past the window and bases past xw read 0 (the kernel's bounds,
    as the forward's select chain leaves a cell past G)."""
    wide = inp["cells"][8]                      # cells in [0, 64)
    val, idx, xw = _np(inp, "val", "idx", "xw")
    y = micro.ladder_reference("window", inp["val"], inp["idx"], wide,
                               inp["xw"], G=2)
    _close_to(y.numpy(), _jax_body("chain", val, idx, wide.numpy(), xw,
                                   None, 2))
    base = inp["base"].clone()
    base[::2] = 32                              # one past the 32 groups
    y = micro.ladder_reference("tilebase", inp["val"], inp["idx"],
                               inp["cell"], inp["xw"], base)
    assert float(y[::2].abs().max()) == 0.0 and float(y[1::2].abs().max()) > 0


def test_ladder_inputs_follow_the_jax_order(inp):
    rng = np.random.default_rng(0)
    rows = N_TILES * 8
    want = [rng.standard_normal((rows, 128)).astype(np.float32),
            rng.integers(0, 128, size=(rows, 128)).astype(np.int16),
            rng.integers(0, 8, size=(rows, 128)).astype(np.int16),
            rng.standard_normal((256, 128)).astype(np.float32),
            rng.integers(0, 32, size=(N_TILES // T, T)).astype(np.int32)]
    got = _np(inp, "val", "idx", "cell", "xw", "base")
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b.reshape(a.shape))
    for G in (2, 8, 32):
        c = inp["cells"][G].numpy()
        assert c.min() >= 0 and c.max() < 8 * G


def test_bench_ladder_on_the_cpu_returns_every_stage():
    gs = (1, 2, 4, 8, 16, 32)
    r = micro.bench_ladder(n_tiles=16, G_list=gs, device="cpu",
                           verbose=False)
    want = ["stream", "lane", "dual", "tilebase"] + [
        micro.stage_name(s, g) for g in gs for s in ("window",
                                                     "window-smem")]
    assert list(r) == want
    for ms, gbs, gslot in r.values():
        assert ms > 0 and gbs > 0 and gslot > 0


def test_stage_checks_raise(inp):
    with pytest.raises(ValueError, match="unknown stage"):
        micro.ladder_reference("chain", inp["val"], inp["idx"], inp["cell"],
                               inp["xw"])
    with pytest.raises(ValueError, match="idx"):
        micro.ladder_stage("lane", inp["val"], inp["idx"].int(), None,
                           inp["xw"])
    with pytest.raises(ValueError, match="base"):
        micro.ladder_stage("tilebase", inp["val"], inp["idx"], inp["cell"],
                           inp["xw"], None)
    with pytest.raises(ValueError, match="xw"):
        micro.ladder_stage("window", inp["val"], inp["idx"], inp["cell"],
                           inp["xw"][:64], G=16)
    with pytest.raises(ValueError, match="multiple of"):
        micro.ladder_inputs(20, (2,), 8, "cpu")
    assert micro.ladder_stage.launches == {}     # no launch on the CPU
    assert torch.equal(micro.ladder_stage(
        "stream", inp["val"], None, None, inp["xw"]),
        micro.ladder_reference("stream", inp["val"], None, None, inp["xw"]))
