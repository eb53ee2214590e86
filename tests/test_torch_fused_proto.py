"""sparsetpu_torch's fused-redesign prototypes (``bench/fused_proto.py``)
against the TPU experiments they port.

``scripts/exp_fused.py``, ``exp_glw.py`` and ``exp_selfirst.py`` keep their
experiment under ``__main__``, so each is imported by path and its own
kernel runs in Pallas interpret mode on the same numpy inputs as the
port's plain version (CPU tensors):

  #20  ``fused_proto`` against exp_fused.py:34 ``make_fused`` (2 slabs of
       16 tiles, GL 4, OT 3, 64 x rows), also with cells past the final's
       select reach, int16 meta with the sign bit set and bases past the
       window (which Pallas clamps);
  #21  ``tile_forward("full", G)`` against exp_glw.py:26 ``fwd_kernel`` at
       4 tiles a step for G = 1, 2, 4, 8, 16; at G = 12 the JAX form raises
       IndexError (``_tree_merge`` halves 12 to 6 to 3);
  #24  ``tile_forward`` full and selfirst at GLW 16 against
       exp_selfirst.py:44 ``_fwd_kernel_a`` and :66 ``_fwd_kernel_b``, the
       module's T patched to 8.

``exp_streams.py`` (#25) runs its timings when imported (its lines
58-115), so its kernels are transcribed here in numpy, with their lines.
``glw_spans`` is held to exp_glw.py:236-241's arithmetic on the JAX
package's ``pack_fused``.

Tolerance: rtol 1e-5, atol 1e-5 * max(1, max|ref|) (the same f32 terms
summed in another order).
"""

import functools
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from sparsetpu_torch import _host
from sparsetpu_torch.bench import fused_proto as fp
from sparsetpu_torch.bench import fused_stages as fs
from test_torch_fused import native_engines

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close_to(y, ref):
    y, ref = np.asarray(y), np.asarray(ref)
    atol = 1e-5 * max(1.0, float(np.abs(ref).max()) if ref.size else 1.0)
    np.testing.assert_allclose(y, ref, rtol=1e-5, atol=atol)


def _script(name, monkeypatch):
    """scripts/<name>.py imported by path, its ``pl.pallas_call`` in
    interpret mode."""
    from jax.experimental import pallas as pl
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    return mod


# -- #20: exp_fused.py -----------------------------------------------------------

PROTO_SMALL = dict(n_slabs=2, st_tiles=16, GL=4, OT=3, x_rows=64)


@pytest.fixture(scope="module")
def proto():
    return fp.fused_proto_inputs(**PROTO_SMALL, device="cpu")


def _jax_proto(mod, a):
    """exp_fused.py:29-98's ``make_fused`` at the inputs' shape."""
    import jax.numpy as jnp
    n_slabs, ST = a["tile_base"].shape
    f = mod.make_fused(n_slabs, ST, a["GL"], -(-ST // 8), a["OT"],
                       a["xw"].shape[0])
    return np.asarray(f(*(jnp.asarray(a[k].numpy()) for k in (
        "tile_base", "xw", "values", "meta", "fcell", "froute"))))


def _proto_cases(a):
    """The script's inputs, then three that reach past them."""
    rng = np.random.default_rng(7)
    n_slabs, ST = a["tile_base"].shape

    def t(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x, dtype))
    return {
        "script": a,
        # cells over every written scratch row, past the SG groups the
        # final's select reaches (exp_fused.py:73-76): those read 0
        "cells_past_reach": dict(a, fcell=t(rng.integers(
            -3, 8 * ST, a["fcell"].shape), np.int16)),
        # any int16 meta: the sign bit masked (exp_fused.py:48), groups
        # past GL read 0 (:54-57)
        "any_meta": dict(a, meta=t(rng.integers(
            -2 ** 15, 2 ** 15, a["meta"].shape), np.int16)),
        # bases past the window: Pallas clamps the dynamic slice, as the
        # kernel clamps the base
        "bases_past_window": dict(a, tile_base=t(rng.integers(
            -2, a["xw"].shape[0] // 8 + 2, (n_slabs, ST)), np.int32)),
    }


@pytest.mark.parametrize("case", ["script", "cells_past_reach", "any_meta",
                                  "bases_past_window"])
def test_fused_proto_matches_the_script_kernel(proto, case, monkeypatch):
    mod = _script("exp_fused", monkeypatch)
    a = _proto_cases(proto)[case]
    y = _jax_proto(mod, a)
    assert y.shape == (PROTO_SMALL["n_slabs"] * PROTO_SMALL["OT"], 128)
    _close_to(fp.fused_proto_reference(**a).numpy(), y)
    _close_to(fp.proto_launch(**a).numpy(), y)
    if case == "script":           # the others hold values it refuses
        _close_to(fp.fused_proto(**a).numpy(), y)
    assert fp.fused_proto.launches == {}           # the plain version ran


def test_fused_proto_inputs_follow_the_script(proto):
    """exp_fused.py:101-122's draws at the small shape."""
    rng = np.random.default_rng(0)
    rows, ST = 2 * 16 * 8, 2
    val = rng.standard_normal((rows, 128)).astype(np.float32)
    cells = rng.integers(0, 8 * 4, size=(rows, 128))
    route = rng.integers(0, 128, size=(rows, 128))
    meta = ((cells << 7) | route).astype(np.int16)
    fcell = rng.integers(0, ST, size=(2 * 3 * 8, 128)).astype(np.int16)
    froute = rng.integers(0, 128, size=(2 * 3 * 8, 128)).astype(np.int8)
    tb = rng.integers(0, max(1, 64 // 8 - 4), size=(2, ST)).astype(np.int32)
    xw = rng.standard_normal((64, 128)).astype(np.float32)
    for k, want in (("values", val), ("meta", meta), ("fcell", fcell),
                    ("froute", froute), ("tile_base", tb), ("xw", xw)):
        assert np.array_equal(proto[k].numpy(), want), k
    assert (proto["GL"], proto["OT"]) == (4, 3)
    full = fp.fused_proto_inputs(n_slabs=1, st_tiles=8, device="cpu")
    assert tuple(full["xw"].shape) == (896, 128)   # 784 padded to 8 GL


def test_fused_proto_checks_raise(proto):
    a = proto
    ST = a["tile_base"].shape[1]
    bad_cell = a["fcell"].clone()
    bad_cell[5, 7] = 8 * ST
    with pytest.raises(ValueError, match="fcell outside"):
        fp.fused_proto(**dict(a, fcell=bad_cell))
    bad_cell[5, 7] = -1
    with pytest.raises(ValueError, match="fcell outside"):
        fp.fused_proto(**dict(a, fcell=bad_cell))
    bad_route = a["froute"].clone()
    bad_route[0, 0] = -5
    with pytest.raises(ValueError, match="froute outside"):
        fp.fused_proto(**dict(a, froute=bad_route))
    far = a["tile_base"].clone()
    far[1, 1] = a["xw"].shape[0] // 8 - a["GL"] + 1
    with pytest.raises(ValueError, match="tile_base outside"):
        fp.fused_proto(**dict(a, tile_base=far))
    with pytest.raises(ValueError, match="meta"):
        fp.fused_proto(**dict(a, meta=a["meta"].int()))
    with pytest.raises(ValueError, match="values has shape"):
        fp.fused_proto(**dict(a, values=a["values"][:-128]))
    with pytest.raises(ValueError, match="fcell has shape"):
        fp.fused_proto(**dict(a, OT=4))
    with pytest.raises(ValueError, match="xw must be"):
        fp.fused_proto(**dict(a, GL=16))
    with pytest.raises(ValueError, match="super-tiles are 8 tiles"):
        fp.fused_proto_inputs(st_tiles=12, device="cpu")
    # the launch-only entry checks shapes and dtypes, not values
    with pytest.raises(ValueError, match="meta"):
        fp.proto_launch(**dict(a, meta=a["meta"].int()))
    with pytest.raises(ValueError, match="values has shape"):
        fp.proto_launch(**dict(a, values=a["values"][:-128]))


# -- #21: exp_glw.py --------------------------------------------------------------

def _jax_glw(mod, glw, a):
    """exp_glw.py:57-66's pallas_call around ``fwd_kernel`` at the inputs'
    shape."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    n_steps, T = a["tile_base"].shape
    gx8 = a["xw"].shape[0]
    gs = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(n_steps,),
        in_specs=[pl.BlockSpec((gx8, 128), lambda i, tbp: (0, 0))]
        + [pl.BlockSpec((T * 8, 128), lambda i, tbp: (i, 0))] * 3,
        out_specs=pl.BlockSpec((T, 128), lambda i, tbp: (i, 0)))
    f = mod.pl.pallas_call(
        functools.partial(mod.fwd_kernel, T=T, GLW=glw), grid_spec=gs,
        out_shape=jax.ShapeDtypeStruct((n_steps * T, 128), jnp.float32))
    return np.asarray(f(*(jnp.asarray(a[k].numpy()) for k in (
        "tile_base", "xw", "values", "i1", "rt"))))


@pytest.mark.parametrize("glw", [1, 2, 4, 8, 16])
def test_glw_forward_matches_the_script_kernel(glw, monkeypatch):
    mod = _script("exp_glw", monkeypatch)
    a = fp.glw_inputs(glw, n_steps=2, T=4, device="cpu")
    y = _jax_glw(mod, glw, a)
    _close_to(fs.tile_forward_reference("full", glw, **a).numpy(), y)
    _close_to(fs.tile_forward("full", glw, **a).numpy(), y)
    assert fs.tile_forward.launches == {}


def test_glw12_is_not_built_by_the_reference(monkeypatch):
    """exp_glw.py:109 asks for GLW 12; ``_tree_merge``
    (sparsetpu/kernels/spmv_fused.py:36-45) halves 12 parts to 6, then 3,
    then indexes past the list while tracing."""
    mod = _script("exp_glw", monkeypatch)
    a = fp.glw_inputs(12, n_steps=1, T=4, device="cpu")
    with pytest.raises(IndexError):
        _jax_glw(mod, 12, a)
    with pytest.raises(ValueError, match="power of two"):
        fs.tile_forward("full", 12, **a)
    assert 12 in fp.GLW_UNBUILT


def test_glw_inputs_follow_the_script():
    """exp_glw.py:45-56's draws, from default_rng(GLW)."""
    rng = np.random.default_rng(8)
    rows = 2 * 4 * 8
    x2 = rng.standard_normal((104 * 8, 128)).astype(np.float32)
    vals = rng.standard_normal((rows, 128)).astype(np.float32)
    i1 = rng.integers(0, 64, (rows, 128)).astype(np.int8)
    rt = rng.integers(0, 128, (rows, 128)).astype(np.int8)
    tb = rng.integers(0, 104 - 8, (2, 4)).astype(np.int32)
    a = fp.glw_inputs(8, n_steps=2, T=4, device="cpu")
    for k, want in (("xw", x2), ("values", vals), ("i1", i1), ("rt", rt),
                    ("tile_base", tb)):
        assert np.array_equal(a[k].numpy(), want), k


def _script_spans(p):
    """exp_glw.py:236-241 on a pack."""
    i1 = p.meta_i1.reshape(-1, 8, 128).astype(np.int32)
    v = p.values.reshape(-1, 8, 128)
    used = v != 0
    rel = np.where(used, i1, 0)
    span = (rel.max(axis=(1, 2)) >> 3) + 1
    return span, [(span <= k).mean() for k in (2, 4, 8, 12, 16)]


@pytest.mark.parametrize("powerlaw", [False, True])
def test_glw_spans_match_the_script_on_the_jax_pack(powerlaw):
    from sparsetpu.formats.random import random_csr as jax_random_csr
    from sparsetpu.pack.fused import pack_fused as jax_pack_fused
    native_engines()
    m_jax = jax_random_csr(3000, 9000, density=0.004, seed=11,
                           dtype=np.float32, powerlaw=powerlaw)
    m = _host.random_csr(3000, 9000, density=0.004, seed=11,
                         dtype=np.float32, powerlaw=powerlaw)
    p_jax, p = jax_pack_fused(m_jax), _host.pack_fused(m)
    span, hist = _script_spans(p_jax)
    r = fp.glw_spans(p)
    assert r["tiles"] == span.size and r["script"] == [float(h) for h in
                                                        hist]
    assert np.array_equal(fp.tile_spans(p, routed=False), span)
    # the routed span, slot by slot: the cell at the lane the route names
    routed = fp.tile_spans(p)
    i1 = p.meta_i1.reshape(-1, 8, 128).astype(np.int32)
    rt = p.meta_rt.reshape(-1, 8, 128).astype(np.int32) & 127
    v = p.values.reshape(-1, 8, 128)
    for t in range(0, span.size, max(1, span.size // 16)):
        cells = [i1[t, s, rt[t, s, lane]] for s in range(8)
                 for lane in range(128) if v[t, s, lane] != 0]
        assert routed[t] == (max(cells, default=0) >> 3) + 1, t
    assert r["differ"] == int((routed != span).sum())
    assert r["routed"] == [float((routed <= k).mean())
                           for k in fp.SPAN_KS]


def test_span_classes_are_the_forward_of_their_tiles():
    """Each class's tiles, run through the full tile at GLW 16, are the
    fused forward's chunk sums of those tiles (P = 1), and the narrow class
    at GLW 8 reads the same addresses: equal to the bit."""
    m, _ = fs.stage_matrix("headline", small=True)
    inp = fs.stage_inputs(m, "cpu")
    dev = inp["device"]
    sums = fs.fused_forward_reference(**inp["fwd"])
    spans = fp.tile_spans(dev.meta)
    classes = fp.span_class_inputs(dev, inp["x2"])
    assert set(classes) == {"narrow", "wide"}
    for name, keep in (("narrow", spans <= 8), ("wide", spans > 8)):
        n, a = classes[name]
        idx = np.resize(np.flatnonzero(keep), spans.size)
        assert n == int(keep.sum()) and a["tile_base"].shape[1] == 16
        y = fs.tile_forward("full", 16, **a)
        _close_to(y.numpy(), sums[torch.from_numpy(idx)].numpy())
    n, a = classes["narrow"]
    assert torch.equal(fs.tile_forward("full", 8, **a),
                       fs.tile_forward("full", 16, **a))


# -- #24: exp_selfirst.py --------------------------------------------------------

@pytest.mark.parametrize("kind,body", [("full", "_fwd_kernel_a"),
                                       ("selfirst", "_fwd_kernel_b")])
def test_selfirst_matches_the_script_kernel(kind, body, monkeypatch):
    import jax.numpy as jnp
    mod = _script("exp_selfirst", monkeypatch)
    monkeypatch.setattr(mod, "T", 8)
    lad = fs.tile_ladder_inputs(1, device="cpu")   # 128 tiles, 16 steps of 8
    a = dict(lad, tile_base=lad["tile_base"].view(16, 8))
    f = mod.build(getattr(mod, body), 16, 800)
    y = np.asarray(f(*(jnp.asarray(a[k].numpy()) for k in (
        "tile_base", "xw", "values", "i1", "rt"))))
    _close_to(fs.tile_forward_reference(kind, 16, **a).numpy(), y)
    for T in (8, 128):          # the result does not depend on the grid
        b = dict(lad, tile_base=lad["tile_base"].view(-1, T))
        _close_to(fs.tile_forward(kind, 16, **b).numpy(), y)


def test_selfirst_reads_the_group_at_the_stripe_cell():
    """Slot (s, l): c = i1[s, j], s' = c & 7, x row 8 b + 8 ((i1[s', j]
    >> 3) & 15) + s' at lane j (exp_selfirst.py:79-83)."""
    lad = fs.tile_ladder_inputs(1, device="cpu")
    idx = fs.tile_gather_index("selfirst", 16, **lad).numpy()
    i1 = lad["i1"].numpy().reshape(-1, 8, 128).astype(np.int64)
    rt = lad["rt"].numpy().reshape(-1, 8, 128).astype(np.int64) & 127
    tb = lad["tile_base"].numpy().reshape(-1)
    rng = np.random.default_rng(3)
    for t, s, lane in rng.integers(0, (128, 8, 128), (64, 3)):
        j = rt[t, s, lane]
        sp = i1[t, s, j] & 7
        row = 8 * tb[t] + 8 * ((i1[t, sp, j] >> 3) & 15) + sp
        assert idx[t, s, lane] == row * 128 + j


def test_tile_forward_checks_raise():
    lad = fs.tile_ladder_inputs(1, device="cpu")
    with pytest.raises(ValueError, match="unknown tile kind"):
        fs.tile_forward("select-first", 16, **lad)
    with pytest.raises(ValueError, match="power of two"):
        fs.tile_forward("selfirst", 6, **lad)
    with pytest.raises(ValueError, match="i1"):
        fs.tile_forward("selfirst", 16, **dict(lad, i1=lad["i1"].short()))
    with pytest.raises(ValueError, match="xw must be"):
        fs.tile_forward("full", 16, **dict(lad, xw=lad["xw"][:64]))


# -- #25: exp_streams.py -----------------------------------------------------------

def _kern8(v, i1, rt, a, b, c, d):
    """exp_streams.py:34-48: the column sums of each block, int8 as f32,
    added in stream order and broadcast to 8 rows."""
    s = v.sum(0, keepdims=True)
    for x in (i1, rt, a, b, c, d):
        s = s + x.astype(np.float32).sum(0, keepdims=True)
    return np.broadcast_to(s, (8, 128))


def _kern2(v, m):
    """exp_streams.py:51-55."""
    return np.broadcast_to(v.sum(0, keepdims=True)
                           + m.astype(np.float32).sum(0, keepdims=True),
                           (8, 128))


def _tpu_streams(inp, form):
    """The grid of exp_streams.py:67-76 (one step a block) and :101-113
    (S steps a block over the first N // S * S steps)."""
    n_in, S = fp.STREAM_FORMS[form]
    n = inp["n_steps"] // S
    arrays = [inp["values"].numpy()] + [
        s.numpy() for s in (inp["split"] if n_in == 7 else [inp["merged"]])]
    blocks = [[a[k * len(a) // inp["n_steps"] * S:
                 (k + 1) * len(a) // inp["n_steps"] * S] for a in arrays]
              for k in range(n)]
    body = _kern8 if n_in == 7 else _kern2
    return np.concatenate([body(*b) for b in blocks])


@pytest.mark.parametrize("form", list(fp.STREAM_FORMS))
def test_streams_match_the_script_kernels(form):
    inp = fp.streams_inputs(6, device="cpu")
    a = fp.stream_args(inp, form)
    y = _tpu_streams(inp, form)
    assert y.shape == (6 // fp.STREAM_FORMS[form][1] * 8, 128)
    _close_to(fp.streams_sum_reference(**a).numpy(), y)
    _close_to(fp.streams_sum(**a).numpy(), y)
    assert fp.streams_sum.launches == {}


def test_streams_inputs_follow_the_script():
    """exp_streams.py:58-65's draws: 155,648 bytes a step in both forms."""
    inp = fp.streams_inputs(3, device="cpu")
    rng = np.random.default_rng(0)
    v = rng.standard_normal((3 * 128, 128)).astype(np.float32)
    split = [rng.integers(0, 100, (3 * r, 128)).astype(np.int8)
             for r in (128, 128, 160, 160, 64, 64)]
    merged = rng.integers(0, 100, (3 * 704, 128)).astype(np.int8)
    assert np.array_equal(inp["values"].numpy(), v)
    for x, want in zip(inp["split"], split):
        assert np.array_equal(x.numpy(), want)
    assert np.array_equal(inp["merged"].numpy(), merged)
    for form in ("7", "2"):
        a = fp.stream_args(inp, form)
        nbytes = sum(t.numel() * t.element_size()
                     for t in [a["values"], *a["streams"]])
        assert nbytes == 3 * 155_648


def test_streams_checks_raise():
    inp = fp.streams_inputs(4, device="cpu")
    a = fp.stream_args(inp, "7")
    with pytest.raises(ValueError, match="6 \\(the 7-input form\\)"):
        fp.streams_sum(a["values"], a["streams"][:3], n_steps=4)
    with pytest.raises(ValueError, match="multiple of"):
        fp.streams_sum(a["values"], a["streams"], n_steps=4, fold=3)
    with pytest.raises(ValueError, match="streams\\[2\\]"):
        fp.streams_sum(a["values"], a["streams"][:2]
                       + [a["streams"][2].short()] + a["streams"][3:],
                       n_steps=4)
    with pytest.raises(ValueError, match="n_steps"):
        fp.streams_sum(a["values"][:-2], a["streams"], n_steps=4)


# -- the bench and its CLI ----------------------------------------------------------

def _timer(fn, dev):
    fn()
    return 1.0


def test_bench_fused_proto_on_the_cpu_returns_every_phase():
    r = fp.bench_fused_proto(device="cpu", small=True, timer=_timer,
                             only=["proto", "glw", "span-class", "selfirst",
                                   "streams@2xS4", "streams@7:20"])
    want = (["proto@3x448", "proto@3x448:workspace", "proto@24x56"]
            + [f"glw@{g}" for g in fp.GLWS]
            + ["span-class:narrow@16", "span-class:wide@16",
               "span-class:narrow@8", "selfirst@A", "selfirst@B",
               "streams@2xS4", "streams@7:20"])
    assert list(r) == want
    assert r["glw@12"] == {"skipped": fp.GLW_UNBUILT[12]}
    for name, ph in r.items():
        if name == "glw@12":
            continue
        assert ph["stream_ms"] == ph["call_ms"] == 1.0, name
        assert ph["bytes"] > 0 and ph["bound_ms"] is None, name
        assert ph["l2_resident"] is False, name
        assert ph["launches"] == {} and "args" in ph, name
    a = r["proto@3x448"]["args"]
    assert r["proto@3x448"]["bytes"] == sum(
        t.numel() * t.element_size() for t in a.values()
        if torch.is_tensor(t)) + 3 * 64 * 128 * 4
    assert r["glw@4"]["ns_tile"] == 1e6 / 256
    assert r["streams@2xS4"]["ns_step"] == 1e6 / 2
    assert r["streams@2xS4"]["ns_substep"] == 1e6 / 8
    assert r["span-class:wide@16"]["distinct_tiles"] > 0


def test_bench_fused_proto_spans_and_timer():
    r = fp.bench_fused_proto(device="cpu", small=True, timer=_timer,
                             only=["spans"])
    (name,) = r
    assert name == "spans@headline" and r[name]["tiles"] == 1536
    assert len(r[name]["script"]) == len(r[name]["routed"]) == 5
    with pytest.raises(ValueError, match="timer"):
        fp.bench_fused_proto(device="cpu", small=True, only=["glw@4"])


def test_cli_on_the_cpu_prints_the_phases(capsys):
    assert fp.main(["--device", "cpu", "--small", "--only",
                    "glw@4,glw@12,streams@2"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert "plain versions" in out[0] and "glw@12: not built" in out[2]
    assert list(json.loads(out[-1])) == ["glw@4", "glw@12", "streams@2"]
