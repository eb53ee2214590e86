"""sparsetpu_torch's select-chain measurement against the per-tile-base
kernels of the TPU experiment #23: ``scripts/exp_r3.py:extra_variants``
(tb_tree16, tb2_tree8) and ``i8_variant`` (tb_tree16_i8, split int8
meta).  ``main``'s five are in ``test_torch_select_chains_r3.py``.

Each script function runs once (T = 128 fixed, so 128 tiles: one grid
step), its ``pl.pallas_call`` in interpret mode under ``jax.jit`` and
recorded (``capture_script``).  Each output is held to
``select_forward_reference`` on the captured inputs; ``tb_tree_inputs``
and ``tb_tree_i8_inputs`` must reproduce the captured arrays; each
compiled kernel runs again on inputs past the script's data: int16 meta
of any 16 bits (cells past 16 groups wrap in the tree; tb2_tree8's range
bit c >> 6 takes 0..3), bases past the window's end and, for the int8
streams, negative bytes, which the wrapper refuses and which interpret
mode wraps as numpy indexes, as the kernel reads them without the check.

Tolerance: rtol 1e-5, atol 1e-5 * max(1, max|ref|) (the same f32 terms
summed in another order).
"""

import numpy as np
import pytest
import torch

from sparsetpu_torch.bench import select_chains as sc
from test_torch_select_chains import capture_script, close_to, torch_args

N_TILES = 128
BASE_ARGS = ("base", "xw", "values", "meta")
I8_ARGS = ("base", "xw", "values", "cells", "routes")
VARIANTS = ("tb_tree16", "tb2_tree8", "tb_tree16_i8")


@pytest.fixture(scope="module")
def kernels():
    extra = capture_script("exp_r3",
                           lambda mod: mod.extra_variants(N_TILES))
    (i8,) = capture_script("exp_r3", lambda mod: mod.i8_variant(N_TILES))
    return dict(zip(VARIANTS, extra + [i8]))


def args_of(variant, arrays) -> dict:
    if variant == "tb_tree16_i8":
        a = torch_args(sc.R3_SETTINGS[variant], I8_ARGS, arrays)
        a["meta"] = (a.pop("cells"), a.pop("routes"))
        return a
    return torch_args(sc.R3_SETTINGS[variant], BASE_ARGS, arrays)


@pytest.mark.parametrize("variant", VARIANTS)
def test_r3_tile_base_kernel_matches_the_script(kernels, variant):
    k = kernels[variant]
    a = args_of(variant, k.args)
    assert k.out.shape == (N_TILES, 128)
    assert a["base"].numel() == N_TILES * (2 if variant == "tb2_tree8"
                                           else 1)
    close_to(sc.select_forward_reference(**a).numpy(), k.out)
    close_to(sc.select_forward(**a).numpy(), k.out)
    assert sc.select_forward.launches == {}


def test_tb_tree_inputs_follow_the_script(kernels):
    """exp_r3.py:264-279, 295-296 and 317-318's draws."""
    a = sc.tb_tree_inputs(N_TILES, device="cpu")
    for variant in ("tb_tree16", "tb2_tree8"):
        want = dict(a, base=a[variant])
        for key, x in zip(BASE_ARGS, kernels[variant].args):
            assert np.array_equal(want[key].numpy(), x), (variant, key)


def test_tb_tree_i8_inputs_follow_the_script(kernels):
    """exp_r3.py:378-392's draws: the int8 cells are the int16 kernel's
    cells as bytes."""
    a = sc.tb_tree_i8_inputs(N_TILES, device="cpu")
    for key, x in zip(I8_ARGS, kernels["tb_tree16_i8"].args):
        assert np.array_equal(a[key].numpy(), x), key


def _past_the_data(variant, k, seed):
    rng = np.random.default_rng(seed)
    args = list(k.args)
    args[0] = rng.integers(0, 140, args[0].shape).astype(np.int32)
    if variant == "tb_tree16_i8":
        args[3] = rng.integers(-128, 128, args[3].shape).astype(np.int8)
        args[4] = rng.integers(-128, 128, args[4].shape).astype(np.int8)
    else:
        args[3] = rng.integers(-2 ** 15, 2 ** 15, args[3].shape).astype(
            np.int16)
    return args


@pytest.mark.parametrize("variant", VARIANTS)
def test_r3_tile_base_kernel_past_the_script_data(kernels, variant):
    k = kernels[variant]
    args = _past_the_data(variant, k, seed=len(variant))
    y = k(*args)
    a = args_of(variant, args)
    close_to(sc.select_forward_reference(**a).numpy(), y)
    if variant == "tb_tree16_i8":
        with pytest.raises(ValueError, match="negative int8"):
            sc.select_forward(**a)
        close_to(sc.select_forward(**a, check=False).numpy(), y)
    else:
        close_to(sc.select_forward(**a).numpy(), y)


def test_tb2_tree8_range_bit_takes_every_value(kernels):
    """c >> 6 takes 0..3 on 15-bit cells; any non-zero value is the second
    window, as exp_r3.py:362 selects on rbit != 0."""
    k = kernels["tb2_tree8"]
    args = _past_the_data("tb2_tree8", k, seed=5)
    a = args_of("tb2_tree8", args)
    _, c = sc._decode(a["values"], a["meta"], False, N_TILES)
    assert set(torch.unique(c >> 6).tolist()) == {0, 1, 2, 3}
    close_to(sc.select_forward(**a).numpy(), k(*args))
