"""sparsetpu_torch's select-chain measurement against the TPU experiment
#23, ``scripts/exp_r3.py``: the five kernels of its ``main`` (chain16,
tree16, hilo16, tb_res, tb_res2).  ``extra_variants`` and ``i8_variant``
are in ``test_torch_select_chains_r3tb.py``, so that the two files run on
two workers.

The script fixes T = 128, so each kernel runs one grid step of 128 tiles:
``main`` with ``sys.argv = ["exp_r3.py", "128", <variant>]``, its
``pl.pallas_call`` in interpret mode under ``jax.jit`` and recorded
(``capture_script``).  Each output is held to ``select_forward_reference``
on the captured inputs; ``select16_inputs(128, {variant})`` must reproduce
the captured arrays (the script draws tb_res's and tb_res2's inputs only
when they run); and each compiled kernel runs again on inputs past the
script's data: int16 meta of any 16 bits (cells past 16 groups, where
chain16 and hilo16 read 0 and tree16 wraps) and bases past the window's
end.  hilo16's kernel folds ``xw[0, 0] * 1e-30`` into each step's first row
(exp_r3.py:157), which the port leaves out: the tolerance covers it.

Tolerance: rtol 1e-5, atol 1e-5 * max(1, max|ref|) (the same f32 terms
summed in another order).
"""

import numpy as np
import pytest

from sparsetpu_torch.bench import select_chains as sc
from test_torch_select_chains import capture_script, close_to, torch_args

N_TILES = 128
# the kernel's arguments in the script's order (hilo16's k_wrap first takes
# the f32 x it folds, then the int16 planes)
MAIN_ARGS = {"chain16": ("xw", "values", "meta"),
             "tree16": ("xw", "values", "meta"),
             "hilo16": ("xw_f32", "xw", "values", "meta"),
             "tb_res": ("base", "xw", "values", "meta"),
             "tb_res2": ("base", "xw", "values", "meta")}
_KERNELS = {}


def kernel(variant):
    """The script's kernel of ``variant``, built once a module."""
    if variant not in _KERNELS:
        (_KERNELS[variant],) = capture_script(
            "exp_r3", lambda mod: mod.main(),
            argv=["exp_r3.py", str(N_TILES), variant])
    return _KERNELS[variant]


def args_of(variant, arrays, **settings) -> dict:
    a = torch_args(dict(sc.R3_SETTINGS[variant], **settings),
                   MAIN_ARGS[variant], arrays)
    a.pop("xw_f32", None)
    return a


@pytest.mark.parametrize("variant", sc.R3_MAIN)
def test_r3_main_kernel_matches_the_script(variant):
    k = kernel(variant)
    a = args_of(variant, k.args)
    assert k.out.shape == (N_TILES, 128)
    close_to(sc.select_forward_reference(**a).numpy(), k.out)
    close_to(sc.select_forward(**a).numpy(), k.out)
    assert sc.select_forward.launches == {}


@pytest.mark.parametrize("variant", sc.R3_MAIN)
def test_r3_main_inputs_follow_the_script(variant):
    """exp_r3.py:57-65, 146-150, 195-198 and 239-242's draws, with the
    script's ``only``."""
    a = sc.select16_inputs(N_TILES, {variant}, device="cpu")
    want = dict(values=a["values"], meta=a["meta"], xw=a["xw"])
    if variant == "hilo16":
        want.update(xw_f32=a["xw"], xw=a["xw_hilo"])
    elif variant.startswith("tb_res"):
        want.update(a[variant])
        assert ({"tb_res", "tb_res2"} - {variant}).isdisjoint(a)
    for key, x in zip(MAIN_ARGS[variant], kernel(variant).args):
        assert np.array_equal(want[key].numpy(), x), key


def _past_the_data(variant, k, seed):
    """int16 meta of any 16 bits, and bases past the window's end."""
    rng = np.random.default_rng(seed)
    args = list(k.args)
    args[-1] = rng.integers(-2 ** 15, 2 ** 15, args[-1].shape).astype(
        np.int16)
    if variant.startswith("tb_res"):
        args[0] = rng.integers(0, 140, args[0].shape).astype(np.int32)
    return args


@pytest.mark.parametrize("variant", sc.R3_MAIN)
def test_r3_main_kernel_past_the_script_data(variant):
    k = kernel(variant)
    args = _past_the_data(variant, k, seed=len(variant))
    y = k(*args)
    a = args_of(variant, args)
    close_to(sc.select_forward_reference(**a).numpy(), y)
    close_to(sc.select_forward(**a).numpy(), y)


def _cells_past_16_groups(k, seed=3):
    """The kernel's inputs with every routed cell in [128, 256)."""
    rng = np.random.default_rng(seed)
    args = list(k.args)
    shape = args[-1].shape
    cells = rng.integers(128, 256, shape)
    args[-1] = ((cells << 7) | rng.integers(0, 128, shape)).astype(np.int16)
    return args


def test_cells_past_16_groups_read_0_in_the_chain_and_wrap_in_the_tree():
    """chain16 and hilo16 (pair >= 8) read 0 past 16 groups; tree16 merges
    on the group's low 4 bits, so it reads group & 15."""
    for variant in ("chain16", "hilo16"):
        k = kernel(variant)
        args = _cells_past_16_groups(k)
        y = k(*args)
        # hilo16's kernel folds xw[0, 0] * 1e-30 into the step's first row
        assert not y[1:].any() and np.abs(y[0]).max() < 1e-29, variant
        assert not sc.select_forward(**args_of(variant, args)).any()
    k = kernel("tree16")
    args = _cells_past_16_groups(k)
    y = k(*args)
    assert np.abs(y).min() > 0
    close_to(sc.select_forward(**args_of("tree16", args)).numpy(), y)
    close_to(sc.select_forward_reference(
        **args_of("chain16", args, mod=True)).numpy(), y)


def test_direct16_computes_chain16s_function():
    """The card's answer to the chain, one load at row c where c >> 3 <
    16, is the script's chain16 on any meta."""
    k = kernel("chain16")
    args = _past_the_data("chain16", k, seed=11)
    a = args_of("chain16", args, form="direct")
    close_to(sc.select_forward(**a).numpy(), k(*args))


def test_tb_res2_takes_its_second_base_for_15_of_16_slots():
    """exp_r3.py:227 says i1 is in [0, 16), but :62 draws cells in
    [0, 128): the range bit (c >> 3) != 0 holds for 15/16 of the slots,
    and the script's kernel, like the port, reads the second base there."""
    k = kernel("tb_res2")
    a = args_of("tb_res2", k.args)
    _, c = sc._decode(a["values"], a["meta"], False, N_TILES)
    far = ((c >> 3) != 0).double().mean().item()
    assert abs(far - 15 / 16) < 0.01
    args = list(k.args)
    base = args[0].copy()
    base.reshape(-1, 2)[:, 1] = 0          # every second base to group 0
    close_to(sc.select_forward(**args_of("tb_res2", [base] + args[1:])),
             k(base, *args[1:]))
    assert not np.allclose(k(base, *args[1:]), k.out)
