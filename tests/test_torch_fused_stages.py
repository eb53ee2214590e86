"""sparsetpu_torch's stage split of the fused kernel
(``bench/fused_stages.py``) against the TPU experiments it ports, and the
port's ``utils/timing.py``.

``scripts/exp_diag_r3.py``, ``exp_diag_r5.py`` and ``exp_asm_r5.py`` run
their experiment on a TPU when imported, so their kernel bodies are
transcribed here in numpy, each with its ``file:line``; the plain versions
(what the CUDA kernels of ``csrc/fused_stages.cu`` are held to on the card)
are held to them:

  fwd       ``fused_forward_reference`` (and the wrapper on CPU tensors)
            against the forward of exp_diag_r5.py:48-64 on the fused packs
            of ``REGIMES`` (P = 8, 4, 2 and 1);
  fwd_s1    ``fused_forward_stage1_reference`` against ``_fused_kernel``'s
            finish stage 1 (sparsetpu/kernels/spmv_fused.py:92-113) on the
            packs with ``fin_direct`` 0;
  ladder    each of the 8 variants of ``tile_ladder_reference`` against
            exp_tile_ladder.py:31-57 in numpy, at both grids; that script
            keeps its experiment under ``__main__``, so ``full-glw16`` also
            runs through its own kernel in Pallas interpret mode, at 2 steps;
  #17       ``tile_base_variants`` against exp_asm_r5.py:107-141's recipe;
  bench     ``bench_fused_stages(device="cpu")`` returns every phase and
            refuses to time without a timer; the CLI on the CPU.

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

import sparsetpu_torch.cli as cli
from sparsetpu_torch.bench import fused_stages as fs
from sparsetpu_torch.kernels.spmv_fused import FusedDevice
from sparsetpu_torch.utils import timing
from test_torch_fused import REGIMES, _pack

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the regimes whose packs have a finish stage 1 (the others: fin_direct 1)
FIN_DIRECT_0 = ["q1_two_stage_sgrp2", "q2", "q4",
                "q8_spills_nonuniform_slabs"]


def _close_to(y, ref):
    y, ref = np.asarray(y), np.asarray(ref)
    atol = 1e-5 * max(1.0, float(np.abs(ref).max()) if ref.size else 1.0)
    np.testing.assert_allclose(y, ref, rtol=1e-5, atol=atol)


def _tree_merge(parts, grp):
    """``_tree_merge`` (exp_tile_ladder.py:20-27, spmv_fused.py:35-45)."""
    level = 0
    while len(parts) > 1:
        bit = (grp & (1 << level)) != 0
        parts = [np.where(bit, parts[i + 1], parts[i])
                 for i in range(0, len(parts), 2)]
        level += 1
    return parts[0]


def _tpu_forward(tb, xw, val, i1r, rt, T, GLW, P):
    """exp_diag_r5.py:48-64's ``fwd_kernel`` (the same body as
    exp_diag_r3.py:29-44 and exp_asm_r5.py:70-85) step by step, with
    ``_fused_kernel``'s split of a tile into P chunk sums
    (spmv_fused.py:84-90) where P > 1."""
    n_steps, Q = tb.shape[0], 8 // P
    out = np.zeros((n_steps * T * P, 128), np.float32)
    for i in range(n_steps):
        for t in range(T):
            sl = slice((i * T + t) * 8, (i * T + t + 1) * 8)
            b = tb[i, t]
            i1 = i1r[sl].astype(np.int32)
            j = rt[sl].astype(np.int32)
            sub = np.bitwise_and(i1, 7)
            grp = np.right_shift(i1, 3)
            xwin = xw[b * 8:b * 8 + 8 * GLW]
            parts = [np.take_along_axis(xwin[g * 8:(g + 1) * 8], sub, axis=0)
                     for g in range(GLW)]
            g1 = _tree_merge(parts, grp)
            g2 = np.take_along_axis(g1, j, axis=1)
            prod = val[sl] * g2
            for p in range(P):
                out[(i * T + t) * P + p] = np.sum(prod[p * Q:(p + 1) * Q],
                                                  axis=0)
    return out


def _tpu_stage1(sums, f1i1, f1rt, n_steps, SR, F1_max, F1A, F1S):
    """``_fused_kernel``'s finish stage 1 (spmv_fused.py:92-113) step by
    step over the chunk sums ``sums`` (n_steps*SR, 128)."""
    SG = SR // 8
    out = np.zeros((n_steps * F1S, 128), np.float32)
    for i in range(n_steps):
        scratch = sums[i * SR:(i + 1) * SR]
        for f in range(F1_max):
            sl = slice((i * F1A + f) * 8, (i * F1A + f + 1) * 8)
            i1 = f1i1[sl].astype(np.int32)
            j = f1rt[sl].astype(np.int32)
            sub = np.bitwise_and(i1, 7)
            grp = np.bitwise_and(np.right_shift(i1, 3), SG - 1)
            parts = [np.take_along_axis(scratch[g * 8:(g + 1) * 8], sub,
                                        axis=0) for g in range(SG)]
            g1 = _tree_merge(parts, grp)
            g1 = np.where(i1 < 0, np.float32(0), g1)
            g2 = np.take_along_axis(g1, j, axis=1)
            out[i * F1S + f] = np.sum(g2, axis=0)
    return out


def _tpu_ladder(variant, tb, xw, val, i1r, rtr):
    """exp_tile_ladder.py:31-57's ``make_kernel`` body, tile by tile, with
    the variant's switches from its table (:95-112)."""
    glw, route, tree, gathers, sum_mode = {
        "full-glw16": (16, 1, 1, 1, 1), "full-glw8": (8, 1, 1, 1, 1),
        "full-glw4": (4, 1, 1, 1, 1), "no-route": (16, 0, 1, 1, 1),
        "no-tree": (16, 1, 0, 1, 1), "no-gathers": (16, 1, 1, 0, 1),
        "no-sum": (16, 1, 1, 1, 0), "bare-glw1": (1, 0, 0, 1, 1)}[variant]
    tb = tb.reshape(-1)
    out = np.zeros((tb.size, 128), np.float32)
    for t in range(tb.size):
        sl = slice(t * 8, (t + 1) * 8)
        b = tb[t]
        i1 = i1r[sl].astype(np.int32)
        sub = np.bitwise_and(i1, 7)
        grp = np.right_shift(i1, 3)
        xwin = xw[b * 8:b * 8 + 8 * glw]
        if gathers:
            parts = [np.take_along_axis(xwin[g * 8:(g + 1) * 8], sub, axis=0)
                     for g in range(glw)]
        else:
            parts = [xwin[g * 8:(g + 1) * 8] for g in range(glw)]
        g1 = _tree_merge(parts, grp) if tree else parts[0]
        if route:
            j = rtr[sl].astype(np.int32)
            g1 = np.take_along_axis(g1, j, axis=1)
        prod = val[sl] * g1
        out[t] = np.sum(prod, axis=0) if sum_mode else prod[0]
    return out


def _np(d, *keys):
    return [d[k].numpy() for k in keys]


# -- fwd and fwd_s1 -----------------------------------------------------------

@pytest.fixture(scope="module")
def packs():
    return {case: FusedDevice.from_packed(_pack(case)[1], "cpu")
            for case in REGIMES}


@pytest.mark.parametrize("case", list(REGIMES))
def test_forward_matches_the_tpu_body(packs, case):
    inp = fs.stage_inputs(packs[case], "cpu")
    f = inp["fwd"]
    tb, val, i1, rt, x2 = _np(f, "tile_base", "values", "meta_i1", "meta_rt",
                              "x2")
    ref = _tpu_forward(tb, x2, val, i1, rt, f["T"], f["GLW"], f["P"])
    _close_to(fs.fused_forward_reference(**f).numpy(), ref)
    _close_to(fs.fused_forward(**f).numpy(), ref)     # CPU: the plain one
    assert fs.fused_forward.launches == 0


def test_regimes_cover_several_planes(packs):
    assert {d.meta.planes for d in packs.values()} >= {1, 2, 4, 8}


@pytest.mark.parametrize("case", FIN_DIRECT_0)
def test_forward_stage1_matches_the_tpu_body(packs, case):
    inp = fs.stage_inputs(packs[case], "cpu")
    s1 = inp["fwd_s1"]
    p = packs[case].meta
    assert s1 is not None and p.fin_direct == 0
    tb, val, i1, rt, x2, f1i1, f1rt = _np(
        s1, "tile_base", "values", "meta_i1", "meta_rt", "x2", "fin1_i1",
        "fin1_rt")
    sums = _tpu_forward(tb, x2, val, i1, rt, p.T, p.GLW, p.planes)
    F1A = f1i1.shape[0] // (p.n_steps * 8)
    ref = _tpu_stage1(sums, f1i1, f1rt, p.n_steps, p.T * p.planes,
                      p.F1_max, F1A, p.F1S)
    _close_to(fs.fused_forward_stage1_reference(**s1).numpy(), ref)
    _close_to(fs.fused_forward_stage1(**s1).numpy(), ref)


def test_stage1_of_a_fin_direct_pack_raises(packs):
    inp = fs.stage_inputs(packs["q1_fin_direct"], "cpu")
    assert inp["fwd_s1"] is None
    d = packs["q1_fin_direct"]
    s1 = dict(inp["fwd"], fin1_i1=d.fin1_i1, fin1_rt=d.fin1_rt,
              F1_max=d.meta.F1_max, F1S=d.meta.F1S, fin_direct=1)
    for fn in (fs.fused_forward_stage1, fs.fused_forward_stage1_reference):
        with pytest.raises(ValueError, match="fin_direct"):
            fn(**s1)


def test_tile_bases_are_clamped_into_x(packs):
    """A base past GX - GLW reads the last window (the kernel's clamp),
    one below 0 the first."""
    f = fs.stage_inputs(packs["q4"], "cpu")["fwd"]
    gx = f["x2"].shape[0] // 8
    lo, hi = torch.zeros_like(f["tile_base"]), torch.full_like(
        f["tile_base"], gx - f["GLW"])
    _close_to(fs.fused_forward(**dict(f, tile_base=lo - 5)).numpy(),
              fs.fused_forward(**dict(f, tile_base=lo)).numpy())
    _close_to(fs.fused_forward(**dict(f, tile_base=hi + 9)).numpy(),
              fs.fused_forward(**dict(f, tile_base=hi)).numpy())


def test_forward_checks_raise(packs):
    f = fs.stage_inputs(packs["q2"], "cpu")["fwd"]
    with pytest.raises(ValueError, match="x2"):
        fs.fused_forward(**dict(f, x2=f["x2"].double()))
    with pytest.raises(ValueError, match="meta_rt"):
        fs.fused_forward(**dict(f, meta_rt=f["meta_rt"][:-8]))
    with pytest.raises(ValueError, match="tile_base"):
        fs.fused_forward(**dict(f, T=f["T"] // 2))
    with pytest.raises(ValueError, match="layout"):
        fs.fused_forward(**dict(f, GLW=3))


# -- #17's tile-base variants -------------------------------------------------

def test_tile_base_variants_follow_the_script_recipe(packs):
    """exp_asm_r5.py:107-141: default_rng(0) for the random bases then the
    random metadata, default_rng(1) for the shuffle."""
    d = packs["q8_spills_nonuniform_slabs"]
    p = d.meta
    got = fs.tile_base_variants(d)
    assert list(got) == list(fs.TILE_BASE_VARIANTS)
    rng = np.random.default_rng(0)
    tb_rand = rng.integers(0, max(p.GX - p.GLW, 1), (p.n_steps, p.T))
    i1_rand = rng.integers(0, 128, d.meta_i1.shape).astype(np.int8)
    rt_rand = rng.integers(0, 128, d.meta_rt.shape).astype(np.int8)
    tb_np = d.tile_base.numpy()
    rng = np.random.default_rng(1)
    tb_shuf = np.stack([rng.permutation(r) for r in tb_np])
    T = tb_np.shape[1]
    order = np.empty(T, np.int64)
    order[0::2] = np.arange(T // 2)
    order[1::2] = np.arange(T // 2, T)
    s = 37 if np.gcd(37, T) == 1 else 41
    want = {"real": (tb_np, d.meta_i1, d.meta_rt),
            "random": (tb_rand, d.meta_i1, d.meta_rt),
            "randmeta": (tb_np, i1_rand, rt_rand),
            "shuffled": (tb_shuf, d.meta_i1, d.meta_rt),
            "interleave": (tb_np[:, order], d.meta_i1, d.meta_rt),
            "stride37": (tb_np[:, (np.arange(T) * s) % T], d.meta_i1,
                         d.meta_rt)}
    for name, (tb, i1, rt) in want.items():
        g = got[name]
        assert g["tile_base"].dtype == torch.int32
        assert np.array_equal(g["tile_base"].numpy(), tb), name
        assert np.array_equal(g["meta_i1"].numpy(), np.asarray(i1)), name
        assert np.array_equal(g["meta_rt"].numpy(), np.asarray(rt)), name
    f = fs.stage_inputs(d, "cpu")["fwd"]
    for name, arrays in got.items():
        assert fs.fused_forward(**dict(f, **arrays)).isfinite().all(), name


# -- the tile ladder ----------------------------------------------------------

@pytest.fixture(scope="module")
def ladder():
    return fs.tile_ladder_inputs(2, 128, device="cpu")


def test_ladder_inputs_follow_the_script_recipe(ladder):
    """exp_tile_ladder.py:82-91, in its order."""
    rng = np.random.default_rng(0)
    rows = 2 * 128 * 8
    want = {"xw": rng.standard_normal((800, 128)).astype(np.float32),
            "values": rng.standard_normal((rows, 128)).astype(np.float32),
            "i1": rng.integers(0, 128, (rows, 128)).astype(np.int8),
            "rt": rng.integers(0, 128, (rows, 128)).astype(np.int8),
            "tile_base": rng.integers(0, 800 // 8 - 16, (2, 128)).astype(
                np.int32)}
    for k, a in want.items():
        assert ladder[k].numpy().dtype == a.dtype
        assert np.array_equal(ladder[k].numpy(), a), k
    fine = fs.tile_ladder_inputs(2, 16, device="cpu")
    assert tuple(fine["tile_base"].shape) == (16, 16)
    assert np.array_equal(fine["tile_base"].numpy().reshape(2, 128),
                          want["tile_base"])
    with pytest.raises(ValueError, match="blocks of"):
        fs.tile_ladder_inputs(1, 48, device="cpu")


@pytest.mark.parametrize("variant", list(fs.LADDER_VARIANTS))
def test_ladder_variant_matches_the_tpu_body(ladder, variant):
    tb, xw, val, i1, rt = _np(ladder, "tile_base", "xw", "values", "i1",
                              "rt")
    ref = _tpu_ladder(variant, tb, xw, val, i1, rt)
    for T in (128, 16):                       # the result is the grid's own
        args = dict(ladder, tile_base=ladder["tile_base"].view(-1, T))
        _close_to(fs.tile_ladder_reference(variant, **args).numpy(), ref)
        _close_to(fs.tile_ladder(variant, **args).numpy(), ref)
    assert fs.tile_ladder.launches == {}


def test_ladder_full_glw16_matches_the_script_kernel(ladder, monkeypatch):
    """The script's own kernel (exp_tile_ladder.py:30-76) in Pallas
    interpret mode at 2 steps."""
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    spec = importlib.util.spec_from_file_location(
        "exp_tile_ladder", os.path.join(REPO, "scripts",
                                        "exp_tile_ladder.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    f = mod.build(mod.make_kernel(glw=16, route=True, tree=True,
                                  gathers=True, sum_mode=True), 2, 800)
    tb, xw, val, i1, rt = _np(ladder, "tile_base", "xw", "values", "i1",
                              "rt")
    y = np.asarray(f(jnp.asarray(tb), jnp.asarray(xw), jnp.asarray(val),
                     jnp.asarray(i1), jnp.asarray(rt)))
    _close_to(fs.tile_ladder_reference("full-glw16", **ladder).numpy(), y)


def test_no_sum_keeps_a_nan_sum(ladder):
    """no-sum stores sublane 0's product, and the sum where it is NaN (the
    predicate that keeps every load of the variant)."""
    vals = ladder["values"].clone()
    vals[8 * 3 + 5, 7] = float("nan")            # tile 3, sublane 5
    y = fs.tile_ladder("no-sum", **dict(ladder, values=vals))
    assert torch.isnan(y[3, 7]) and int(torch.isnan(y).sum()) == 1


def test_ladder_checks_raise(ladder):
    with pytest.raises(ValueError, match="unknown ladder variant"):
        fs.tile_ladder("full-glw2", **ladder)
    with pytest.raises(ValueError, match="rt"):
        fs.tile_ladder("no-tree", **dict(ladder, rt=ladder["rt"].int()))
    with pytest.raises(ValueError, match="xw"):
        fs.tile_ladder("full-glw16", **dict(ladder, xw=ladder["xw"][:64]))


# -- bench_fused_stages and the CLI -------------------------------------------

def _timer(fn, dev):
    fn()
    return 1.0


def test_bench_fused_stages_on_the_cpu_returns_every_phase(packs, tmp_path):
    d = packs["q4"]
    r = fs.bench_fused_stages(d, device="cpu", timer=_timer,
                              profile_dir=str(tmp_path))
    want = ["fwd", "fwd_s1", "blocks", "blocks+flat", "blocks+flat+slice",
            "dev.spmv"] + [f"fwd@{v}" for v in fs.TILE_BASE_VARIANTS[1:]] \
        + [f"ladder:{v}@{T}" for T in (128, 16) for v in fs.LADDER_VARIANTS]
    assert list(r) == want
    for name, ph in r.items():
        assert ph["stream_ms"] == ph["call_ms"] == 1.0, name
        assert ph["bytes"] > 0 and ph["bound_ms"] is None, name
        assert ph["launches"] == {}, name        # plain versions only
    p = d.meta
    assert r["fwd"]["bytes"] == (p.n_steps * p.T * 1024 * 6
                                 + p.n_steps * p.T * 4 + p.GX * 8 * 128 * 4
                                 + p.n_steps * p.T * p.planes * 512)
    assert r["ladder:no-route@16"]["bytes"] == \
        r["ladder:full-glw16@16"]["bytes"] - 2 * 128 * 1024
    assert r["dev.spmv"]["profile"] and os.listdir(tmp_path)
    assert list(fs.bench_fused_stages(d, device="cpu", timer=_timer,
                                      only=["fwd", "ladder:no-sum"],
                                      tiles_per_block=32)) == [
        "fwd", "ladder:no-sum@128", "ladder:no-sum@32"]
    assert list(fs.bench_fused_stages(d, device="cpu", timer=_timer,
                                      only=["bases", "dev.spmv"])) == [
        "dev.spmv"] + [f"fwd@{v}" for v in fs.TILE_BASE_VARIANTS[1:]]


def test_bench_fused_stages_skips_stage1_of_a_fin_direct_pack(packs):
    r = fs.bench_fused_stages(packs["q1_fin_direct"], device="cpu",
                              timer=_timer, only=["fwd_s1", "blocks"])
    assert list(r) == ["fwd_s1", "blocks"]
    assert "fin_direct" in r["fwd_s1"]["skipped"]


def test_bench_fused_stages_needs_a_timer_on_the_cpu(packs):
    with pytest.raises(ValueError, match="timer"):
        fs.bench_fused_stages(packs["q4"], device="cpu")


def test_stage_matrix_names():
    m, label = fs.stage_matrix("headline", small=True)
    assert (m.nr_rows, m.nr_cols) == (20_000, 100_000)
    assert m.values.dtype == np.float32 and label.startswith("headline")
    with pytest.raises(KeyError, match="headline or one of"):
        fs.stage_matrix("nosuchmatrix")


def test_cli_on_the_cpu_prints_the_phases(capsys):
    assert fs.main(["headline", "--device", "cpu", "--small", "--only",
                    "ladder:bare-glw1", "--tiles-per-block", "64"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert "steps=12 T=128" in out[0] and "plain versions" in out[1]
    assert list(json.loads(out[-1])) == ["ladder:bare-glw1@128",
                                         "ladder:bare-glw1@64"]


# -- utils/timing.py ----------------------------------------------------------

def test_phase_timer_report_matches_jax():
    from sparsetpu.utils.timing import PhaseTimer as JaxPhaseTimer
    a, b = timing.PhaseTimer(), JaxPhaseTimer()
    for name, sec in (("Scan matrix", 0.0123456), ("HW (kernel)", 2.5e-5),
                      ("Scan matrix", 0.001)):
        a.record(name, sec)
        b.record(name, sec)
    assert a.report() == b.report() and a.ms("HW (kernel)") == b.ms(
        "HW (kernel)")
    with a.phase("block"):
        pass
    assert a.phases["block"] >= 0.0
    assert a.report().splitlines()[-1].startswith("block execution time ")


def test_maybe_profiler_trace_none_is_a_noop(tmp_path):
    with timing.maybe_profiler_trace(None) as prof:
        torch.ones(3).sum()
    assert prof is None and not os.listdir(tmp_path)


def test_maybe_profiler_trace_writes_a_trace_on_the_cpu(tmp_path):
    out = tmp_path / "trace"
    with timing.maybe_profiler_trace(str(out)) as prof:
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    (name,) = os.listdir(out)
    with open(out / name) as f:
        assert "traceEvents" in json.load(f)
    assert any("mm" in e.key for e in prof.key_averages())


def test_cli_profile_writes_a_trace(tmp_path, capsys):
    assert cli.main(["--device", "cpu", "--random", "600x900x0.01",
                     "--repeats", "2", "--profile", str(tmp_path)]) == 0
    assert "profiler trace written" in capsys.readouterr().out
    assert len(os.listdir(tmp_path)) == 1

