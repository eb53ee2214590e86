"""The select chains on the card: ``select_forward`` in every form (chain,
tree, direct, hilo), at G = 1 to 32, P = 1 and 4, with none, one and two
bases a tile, fused int16 and split int8 meta, each against its plain
PyTorch version; and ``bench_select_chains`` at small shapes.

Imports nothing of JAX, so it runs on the card's machine:
``python -m pytest tests/test_torch_select_chains_gpu.py -m gpu
--noconftest``; without a card every test skips.  Tolerance: rtol 1e-5,
atol 1e-5 * max(1, max|ref|) (the same f32 terms summed in another order).
"""

import numpy as np
import pytest
import torch

from sparsetpu_torch.bench import select_chains as sc


def _close_to(y, ref):
    y, ref = y.cpu().numpy(), ref.cpu().numpy()
    atol = 1e-5 * max(1.0, float(np.abs(ref).max()) if ref.size else 1.0)
    np.testing.assert_allclose(y, ref, rtol=1e-5, atol=atol)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _inputs(dev, form, G, n_bases, split, n_tiles=300, groups=40, seed=0):
    """Random inputs past any script's: meta of any 16 bits (any int8 byte
    >= 0 when split), bases past the window's end; ``groups`` of x (for
    hilo its two planes of 8G rows)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = n_tiles * 8

    def ints(lo, hi, shape, dtype):
        return torch.randint(lo, hi, shape, device=dev, generator=g,
                             dtype=dtype)
    a = dict(values=torch.randn(rows, 128, device=dev, generator=g))
    a["meta"] = ((ints(0, 128, (rows, 128), torch.int8),
                  ints(0, 128, (rows, 128), torch.int8)) if split
                 else ints(-2 ** 15, 2 ** 15, (rows, 128), torch.int16))
    x = torch.randn(8 * (G if form == "hilo" else groups), 128, device=dev,
                    generator=g)
    a["xw"] = sc.hilo_planes(x) if form == "hilo" else x
    if n_bases:
        a["base"] = ints(0, groups + 4, (n_tiles * n_bases,), torch.int32)
    return a


# (form, G, P, bases a tile, split meta, mod)
CASES = [
    ("chain", 1, 1, 0, False, True), ("chain", 32, 4, 0, False, True),
    ("chain", 32, 1, 0, False, False), ("chain", 4, 4, 1, False, False),
    ("chain", 2, 1, 2, False, False), ("chain", 16, 2, 1, True, False),
    ("tree", 1, 1, 2, False, False), ("tree", 16, 1, 1, False, False),
    ("tree", 8, 1, 2, False, False), ("tree", 32, 4, 0, False, False),
    ("tree", 16, 1, 1, True, False),
    ("direct", 1, 1, 1, False, True), ("direct", 32, 1, 0, False, True),
    ("direct", 16, 1, 0, False, False), ("direct", 1, 1, 2, False, False),
    ("direct", 8, 4, 1, True, True),
    ("hilo", 16, 1, 0, False, False), ("hilo", 32, 4, 0, False, True),
    ("hilo", 2, 2, 0, True, False),
]


@pytest.mark.gpu
@pytest.mark.parametrize("form, G, P, n_bases, split, mod", CASES)
def test_select_forward_matches_plain_on_card(cuda, form, G, P, n_bases,
                                             split, mod):
    a = _inputs(cuda, form, G, n_bases, split)
    key = form + ("_i8" if split else "")
    for T in (128, 16):
        n0 = sc.select_forward.launches[key]
        yk = sc.select_forward(form, **a, G=G, P=P, mod=mod, T=T,
                               check=False)
        torch.cuda.synchronize()
        assert sc.select_forward.launches[key] == n0 + 1
        assert tuple(yk.shape) == (300 * P, 128)
        _close_to(yk, sc.select_forward_reference(form, **a, G=G, P=P,
                                                  mod=mod))


@pytest.mark.gpu
def test_select_forward_checks_on_card(cuda):
    a = _inputs(cuda, "tree", 16, 1, True)
    cells, routes = a["meta"]
    bad = cells.clone()
    bad[7, 9] = -4
    with pytest.raises(ValueError, match="negative int8"):
        sc.select_forward("tree", **dict(a, meta=(bad, routes)), G=16)
    a = _inputs(cuda, "chain", 1, 1, False)
    with pytest.raises(ValueError, match="no window to select from"):
        sc.select_forward("chain", **a, G=1)
    with pytest.raises(ValueError, match="meta"):
        sc.select_forward("chain", **dict(a, meta=a["meta"].cpu()), G=1)


@pytest.mark.gpu
def test_script_inputs_on_card(cuda):
    """Each script kernel's phase on the card at the scripts' own recipes
    (tile counts cut by 32), against its plain version."""
    r = sc.bench_select_chains(device=cuda, small=True,
                               only=["q:chain@32,4", "q:tilebase@32",
                                     "q:tb@2,4", "r3:hilo16",
                                     "r3:tb_res2:1024", "r3:tb2_tree8",
                                     "r3:tb_tree16_i8"])
    assert list(r) == ["q:chain@32,4", "q:tilebase@32", "q:tb@2,4",
                       "r3:hilo16", "r3:tb2_tree8", "r3:tb_tree16_i8",
                       "q:chain@32,4:1024", "q:tilebase@32:1024",
                       "q:tb@2,4:1024", "r3:hilo16:1024", "r3:tb_res2:1024",
                       "r3:tb2_tree8:1024", "r3:tb_tree16_i8:1024",
                       "r3:hilo16:1024:T16"]
    for name, ph in r.items():
        assert ph["stream_ms"] > 0 and ph["call_ms"] > 0, name
        assert (ph["bound_ms"] is None) == (":1024" not in name), name
        assert sum(ph["launches"].values()) == 156, name
        a = ph["args"]
        _close_to(sc.select_forward(**a), sc.select_forward_reference(**a))
    assert r["r3:tb_tree16_i8"]["launches"] == {"tree_i8": 156}
    assert r["q:tilebase@32"]["launches"] == {"direct": 156}
