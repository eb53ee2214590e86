"""sparsetpu_torch's select-chain measurement (``bench/select_chains.py``)
against the TPU experiment #22, ``scripts/exp_q.py``, and the wrapper's
checks and bench.

The script is imported by path; its ``pl.pallas_call`` runs in Pallas
interpret mode under ``jax.jit``, recording each built kernel's inputs and
output, and its ``timeit_chained`` calls once (``capture_script``, which
the exp_r3.py tests share).  ``main(n_tiles=8, T=4)`` with the 18 default
(G, P) combos, bigdual and tilebase, then ``tilebase_variants(8, 4)``,
build the script's 28 kernels; each output is held to
``select_forward_reference`` (and ``select_forward`` on CPU tensors) on the
captured inputs, the input functions must reproduce the captured arrays,
and each compiled kernel runs again, at the same shapes, on inputs past the
script's data: int16 meta of any 16 bits and bases past the window's end
(whose start the dynamic slice clamps, as the kernel clamps the base).  A
negative base the wrapper refuses: interpret mode wraps it as numpy
indexes, where the kernel clamps it to 0.

Tolerance: rtol 1e-5, atol 1e-5 * max(1, max|ref|) (the same f32 terms
summed in another order).
"""

import dataclasses
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from sparsetpu_torch.bench import select_chains as sc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def close_to(y, ref):
    y, ref = np.asarray(y), np.asarray(ref)
    atol = 1e-5 * max(1.0, float(np.abs(ref).max()) if ref.size else 1.0)
    np.testing.assert_allclose(y, ref, rtol=1e-5, atol=atol)


@dataclasses.dataclass
class Kernel:
    """One kernel a script built: its inputs and output as numpy, and the
    jitted interpret-mode call, to run again at the same shapes."""
    args: list
    out: np.ndarray
    fn: object

    def __call__(self, *args):
        return np.asarray(self.fn(*args))


def capture_script(name, run, argv=None) -> list:
    """Import scripts/<name>.py by path and call ``run(module)`` with its
    ``pl.pallas_call`` in interpret mode under ``jax.jit``, recording each
    kernel call, and its ``timeit_chained`` calling once; ``argv`` replaces
    ``sys.argv`` meanwhile.  Returns the ``Kernel``s in call order."""
    import jax
    from jax.experimental import pallas as pl
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    real = pl.pallas_call
    calls = []

    def interpret(*a, **k):
        f = jax.jit(real(*a, interpret=True, **k))

        def call(*args):
            out = f(*args)
            calls.append(Kernel([np.asarray(x) for x in args],
                                np.asarray(out), f))
            return out
        return call

    def once(make_call, xw, *a, **k):
        make_call(xw)
        return 1.0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", interpret)
        mp.setattr(mod, "timeit_chained", once)
        if argv is not None:
            mp.setattr(sys, "argv", argv)
        run(mod)
    return calls


def torch_args(settings, names, arrays) -> dict:
    """``select_forward``'s arguments from a kernel's captured arrays, in
    the script's argument order ``names``."""
    a = dict(settings)
    for k, x in zip(names, arrays):
        a[k] = torch.from_numpy(np.array(x))
    return a


# -- #22: exp_q.py ------------------------------------------------------------

N_TILES, T = 8, 4
SCRIPT_ARGS = ("xw", "values", "meta")
BASE_ARGS = ("base", "xw", "values", "meta")
# the script's kernels in call order: (name, settings, argument names)
Q_KERNELS = (
    [(f"chain@{g},{p}", dict(form="chain", G=g, P=p, mod=True), SCRIPT_ARGS)
     for g, p in sc.Q_COMBOS]
    + [(f"bigdual@{g}", dict(form="direct", G=g, mod=True), SCRIPT_ARGS)
       for g in sc.Q_BIGDUAL]
    + [("tilebase@32", dict(form="direct", G=1, mod=True), BASE_ARGS)]
    + [(f"tb@{g},{p}", dict(form="chain", G=g, P=p), BASE_ARGS)
       for g, p in sc.TB_COMBOS])
Q_NAMES = [k for k, _, _ in Q_KERNELS]


@pytest.fixture(scope="module")
def q_kernels():
    def run(mod):
        mod.main(n_tiles=N_TILES, T=T, combos=list(sc.Q_COMBOS),
                 extras=("bigdual", "tilebase"))
        mod.tilebase_variants(n_tiles=N_TILES, T=T)
    calls = capture_script("exp_q", run)
    assert len(calls) == len(Q_KERNELS)
    return {name: (settings, names, k)
            for (name, settings, names), k in zip(Q_KERNELS, calls)}


@pytest.mark.parametrize("name", Q_NAMES)
def test_q_kernel_matches_the_script(q_kernels, name):
    settings, names, k = q_kernels[name]
    a = torch_args(settings, names, k.args)
    P = settings.get("P", 1)
    assert k.out.shape == (N_TILES * P, 128)
    close_to(sc.select_forward_reference(**a).numpy(), k.out)
    close_to(sc.select_forward(**a).numpy(), k.out)
    assert sc.select_forward.launches == {}        # the plain version ran


def _past_the_data(name, k, seed):
    """The kernel's inputs with int16 meta of any 16 bits (cells and the
    sign bit over their whole range; at GL = 1 cells stay < 8, the one
    group the script's take reaches) and, where the kernel takes bases,
    bases past the window's end."""
    rng = np.random.default_rng(seed)
    args = list(k.args)
    m = args[-1]
    meta = rng.integers(-2 ** 15, 2 ** 15, m.shape)
    if name.startswith("tb@1,"):
        meta = (meta & ~(0xF8 << 7)).astype(np.int64)
    args[-1] = meta.astype(np.int16)
    if len(args) == 4:
        args[0] = rng.integers(0, 40, args[0].shape).astype(np.int32)
    return args


@pytest.mark.parametrize("name", Q_NAMES)
def test_q_kernel_past_the_script_data(q_kernels, name):
    settings, names, k = q_kernels[name]
    args = _past_the_data(name, k, seed=Q_NAMES.index(name))
    y = k(*args)
    a = torch_args(settings, names, args)
    close_to(sc.select_forward_reference(**a).numpy(), y)
    close_to(sc.select_forward(**a).numpy(), y)


def test_q_inputs_follow_the_script(q_kernels):
    """exp_q.py:38-44, 122-123 and 149-162's draws, array for array."""
    a = sc.gather_rate_inputs(N_TILES, T, device="cpu")
    for name, (_, names, k) in q_kernels.items():
        if name.startswith("tb@"):
            continue
        for key, x in zip(names, k.args):
            assert np.array_equal(a[key].numpy(), x), (name, key)
    tv = sc.tilebase_variant_inputs(N_TILES, T, device="cpu")
    for g, p in sc.TB_COMBOS:
        _, names, k = q_kernels[f"tb@{g},{p}"]
        v = dict(tv["variants"][(g, p)], xw=tv["xw"], values=tv["values"])
        for key, x in zip(names, k.args):
            assert np.array_equal(v[key].numpy(), x), (g, p, key)


def test_q_take_past_one_group_raises(q_kernels):
    """tb@1,P takes from one 8-row group with no select (exp_q.py:171-172):
    a cell past it reads no value there (NaN in interpret mode), and the
    wrapper refuses it; without the check the kernel's chain reads 0."""
    settings, names, k = q_kernels["tb@1,1"]
    args = list(k.args)
    meta = args[-1].copy()
    meta[:, :] = (9 << 7) | 3          # every slot: cell 9, route 3
    args[-1] = meta
    assert np.isnan(k(*args)).all()
    a = torch_args(settings, names, args)
    with pytest.raises(ValueError, match="no window to select from"):
        sc.select_forward(**a)
    assert not sc.select_forward(**a, check=False).any()


def test_q_negative_base_raises(q_kernels):
    """A negative base: the script's interpret-mode slice wraps its start
    (-24 of 256 rows reads from row 232), the kernel would clamp it to 0;
    the wrapper refuses it."""
    settings, names, k = q_kernels["tilebase@32"]
    args = list(k.args)
    base = args[0].copy()
    base[0, 1] = -3
    wrapped = args[0].copy()
    wrapped[0, 1] = 29
    close_to(k(*([base] + args[1:])), k(*([wrapped] + args[1:])))
    with pytest.raises(ValueError, match="negative window base"):
        sc.select_forward(**torch_args(settings, names, [base] + args[1:]))


# -- the wrapper's checks -----------------------------------------------------

@pytest.fixture(scope="module")
def small():
    a = sc.gather_rate_inputs(16, 8, device="cpu")
    return dict(xw=a["xw"], values=a["values"], meta=a["meta"])


def test_select_forward_checks_raise(small):
    a = small
    with pytest.raises(ValueError, match="unknown form"):
        sc.select_forward("select", **a, G=4)
    for form in ("chain", "tree", "direct"):
        with pytest.raises(ValueError, match="power of two"):
            sc.select_forward(form, **a, G=12)
    with pytest.raises(ValueError, match="hilo: >= 2"):
        sc.select_forward("hilo", **dict(a, xw=sc.hilo_planes(a["xw"])),
                          G=1)
    with pytest.raises(ValueError, match="P=3"):
        sc.select_forward("chain", **a, G=4, P=3)
    with pytest.raises(ValueError, match="meta"):
        sc.select_forward("chain", **dict(a, meta=a["meta"].int()), G=4)
    with pytest.raises(ValueError, match="values must be"):
        sc.select_forward("chain", **dict(a, values=a["values"][:-3]), G=4)
    with pytest.raises(ValueError, match="meta has shape"):
        sc.select_forward("chain", **dict(a, meta=a["meta"][:-8]), G=4)
    with pytest.raises(ValueError, match="xw must be"):
        sc.select_forward("chain", **dict(a, xw=a["xw"][:64]), G=16)
    with pytest.raises(ValueError, match="xw"):
        sc.select_forward("hilo", **a, G=16)        # hilo reads int16 planes
    with pytest.raises(ValueError, match="one or two"):
        sc.select_forward("chain", **a, G=4,
                          base=torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="base"):
        sc.select_forward("chain", **a, G=4,
                          base=torch.zeros(16, dtype=torch.int64))
    with pytest.raises(ValueError, match="cells, routes"):
        sc.select_forward("tree", **dict(a, meta=(a["meta"],)), G=16)
    cells = (a["meta"] & 127).to(torch.int8)
    with pytest.raises(ValueError, match="cells"):
        sc.select_forward("tree", **dict(a, meta=(cells.short(), cells)),
                          G=16)
    bad = cells.clone()
    bad[3, 5] = -1
    for meta in ((bad, cells), (cells, bad)):
        with pytest.raises(ValueError, match="negative int8"):
            sc.select_forward("tree", **dict(a, meta=meta), G=16)
        sc.select_forward("tree", **dict(a, meta=meta), G=16, check=False)
    with pytest.raises(ValueError, match="unsupported device"):
        sc.select_forward("chain", **{k: v.to("meta") for k, v in a.items()},
                          G=4, check=False)


def test_hilo_planes_round_trip(small):
    """exp_r3.py:146-150's planes hold x bit for bit."""
    x = small["xw"]
    planes = sc.hilo_planes(x)
    assert planes.dtype == torch.int16 and planes.shape == (512, 128)
    w = x.numpy().view(np.int32)
    assert np.array_equal(planes.numpy(), np.concatenate(
        [(w >> 16).astype(np.int16), (w & 0xFFFF).astype(np.int16)]))
    assert torch.equal(sc.hilo_x(planes).view(torch.int32),
                       x.view(torch.int32))


def test_forms_share_one_function_where_they_should(small):
    """On cells in the window every form reads the same x; past it the
    chain, direct and hilo forms read 0 and the tree wraps."""
    a = dict(small, xw=small["xw"][:128])
    ref = {f: sc.select_forward_reference(
        f, **(dict(a, xw=sc.hilo_planes(a["xw"])) if f == "hilo" else a),
        G=16) for f in sc.FORMS}
    close_to(ref["chain"], ref["direct"])
    close_to(ref["chain"], ref["hilo"])
    wrapped = sc.select_forward_reference("chain", **a, G=16, mod=True)
    close_to(ref["tree"], wrapped)
    assert not np.allclose(ref["tree"], ref["chain"])


# -- the bench and its CLI ----------------------------------------------------

def _timer(fn, dev):
    fn()
    return 1.0


def test_bench_select_chains_on_the_cpu_returns_every_phase():
    r = sc.bench_select_chains(device="cpu", small=True, timer=_timer)
    q_n, r3_n, big = sc.tile_counts(small=True)
    names = ([f"q:chain@{g},{p}" for g, p in sc.Q_COMBOS]
             + [f"q:bigdual@{g}" for g in sc.Q_BIGDUAL] + ["q:tilebase@32"]
             + [f"q:tb@{g},{p}" for g, p in sc.TB_COMBOS]
             + [f"r3:{v}" for v in sc.R3_PHASES])
    assert list(r) == names + [f"{n}:{big}" for n in names] + [
        f"r3:{v}:{big}:T16" for v in ("chain16", "tree16", "hilo16",
                                      "direct16")]
    assert len(r) == 2 * (18 + 3 + 1 + 6 + 9) + 4
    for name, ph in r.items():
        n = big if f":{big}" in name else (
            q_n if name.startswith("q:") else r3_n)
        a = ph["args"]
        assert ph["tiles"] == n and a["values"].shape == (n * 8, 128), name
        assert a.get("T", sc.SCRIPT_T) == (16 if name.endswith(":T16")
                                            else 128), name
        assert ph["stream_ms"] == ph["call_ms"] == 1.0, name
        assert ph["bound_ms"] is None and ph["launches"] == {}, name
        assert ph["gslot_s"] == n * 1024 / 1e6, name
        assert ph["bytes"] == sc.phase_bytes(a), name
    a = r["q:tb@2,4"]["args"]
    assert r["q:tb@2,4"]["bytes"] == (q_n * 1024 * 6 + 256 * 512 + q_n * 4
                                      + q_n * 4 * 512)
    a = r["r3:tb_tree16_i8"]["args"]
    assert isinstance(a["meta"], tuple) and a["base"].numel() == r3_n
    assert r["r3:tb2_tree8"]["args"]["base"].numel() == 2 * r3_n
    assert r["r3:hilo16"]["args"]["xw"].dtype == torch.int16
    with pytest.raises(ValueError, match="timer"):
        sc.bench_select_chains(device="cpu", small=True, only=["q"])


@pytest.mark.parametrize("only, want", [
    (["q:chain@16,1"], ["q:chain@16,1", "q:chain@16,1:1024"]),
    (["q:bigdual"], ["q:bigdual@4", "q:bigdual@8", "q:bigdual@32",
                     "q:bigdual@4:1024", "q:bigdual@8:1024",
                     "q:bigdual@32:1024"]),
    (["r3:tb_res:1024", "q:tb@2,4"], ["q:tb@2,4", "q:tb@2,4:1024",
                                      "r3:tb_res:1024"]),
    (["r3:direct16", "r3:tb_res2"], ["r3:direct16", "r3:tb_res2",
                                     "r3:direct16:1024", "r3:tb_res2:1024",
                                     "r3:direct16:1024:T16"]),
    (["r3:tree16:1024:T16"], ["r3:tree16:1024:T16"]),
])
def test_bench_only_keeps_what_it_names(only, want):
    r = sc.bench_select_chains(device="cpu", small=True, timer=_timer,
                               only=only)
    assert list(r) == want


def test_r3_draws_follow_only():
    """exp_r3.py draws tb_res's bases and x only when it runs (:55, :195),
    so tb_res2's are the first draws after xw when it runs alone."""
    both = sc.select16_inputs(128, device="cpu")
    alone = sc.select16_inputs(128, {"tb_res2"}, device="cpu")
    assert "tb_res" not in alone and "tb_res" in both
    rng = np.random.default_rng(0)
    rng.standard_normal((1024, 128))
    rng.integers(0, 128, (1024, 128))
    rng.integers(0, 128, (1024, 128))
    rng.standard_normal((128, 128))
    assert np.array_equal(alone["tb_res2"]["base"].numpy(),
                          rng.integers(0, 128, (1, 256)))
    assert not torch.equal(alone["tb_res2"]["base"],
                           both["tb_res2"]["base"])


def test_cli_on_the_cpu_prints_the_phases(capsys):
    assert sc.main(["--device", "cpu", "--small", "--only",
                    "q:chain@2,4", "r3:tree16:1024"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert "plain versions" in out[0] and "q:chain@2,4" in out[1]
    assert list(json.loads(out[-1])) == ["q:chain@2,4", "q:chain@2,4:1024",
                                         "r3:tree16:1024"]
