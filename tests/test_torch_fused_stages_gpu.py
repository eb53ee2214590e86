"""The fused kernel's stage split on the card: the kernels of
``csrc/fused_stages.cu`` (the forward, the forward with finish stage 1,
the 8 tile-ladder variants) against their plain PyTorch versions, and
``bench_fused_stages`` on a small pack.

Imports nothing of JAX, so it runs on the card's machine:
``python -m pytest tests/test_torch_fused_stages_gpu.py -m gpu
--noconftest``; without a card every test skips.  Tolerance: rtol 1e-5,
atol 1e-5 * max(1, max|ref|) (the same f32 terms summed in another order).
"""

import numpy as np
import pytest
import torch

from sparsetpu_torch.bench import fused_stages as fs
from sparsetpu_torch.kernels.spmv_fused import FusedDevice
from test_torch_fused import REGIMES, _pack


def _close_to(y, ref):
    y, ref = y.cpu().numpy(), ref.cpu().numpy()
    atol = 1e-5 * max(1.0, float(np.abs(ref).max()) if ref.size else 1.0)
    np.testing.assert_allclose(y, ref, rtol=1e-5, atol=atol)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _inputs(case, cuda):
    return fs.stage_inputs(FusedDevice.from_packed(_pack(case)[1], cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(REGIMES))
def test_forward_kernels_match_plain_on_card(cuda, case):
    inp = _inputs(case, cuda)
    n0 = fs.fused_forward.launches
    yk = fs.fused_forward(**inp["fwd"])
    torch.cuda.synchronize()
    assert fs.fused_forward.launches == n0 + 1
    _close_to(yk, fs.fused_forward_reference(**inp["fwd"]))
    if inp["fwd_s1"] is None:
        assert inp["device"].meta.fin_direct
        return
    n0 = fs.fused_forward_stage1.launches
    yk = fs.fused_forward_stage1(**inp["fwd_s1"])
    torch.cuda.synchronize()
    assert fs.fused_forward_stage1.launches == n0 + 1
    _close_to(yk, fs.fused_forward_stage1_reference(**inp["fwd_s1"]))


@pytest.mark.gpu
def test_forward_at_every_tile_base_input_on_card(cuda):
    inp = _inputs("q8_spills_nonuniform_slabs", cuda)
    f = inp["fwd"]
    for name, arrays in fs.tile_base_variants(inp["device"]).items():
        args = dict(f, **arrays)
        _close_to(fs.fused_forward(**args), fs.fused_forward_reference(**args))
    gx = f["x2"].shape[0] // 8
    far = torch.full_like(f["tile_base"], 10 * gx)    # clamped into x2
    args = dict(f, tile_base=far)
    _close_to(fs.fused_forward(**args), fs.fused_forward_reference(**args))


@pytest.mark.gpu
@pytest.mark.parametrize("variant", list(fs.LADDER_VARIANTS))
def test_tile_ladder_matches_plain_on_card(cuda, variant):
    lad = fs.tile_ladder_inputs(2, device=cuda)
    for T in (128, 16, 256):
        args = dict(lad, tile_base=lad["tile_base"].view(-1, T))
        n0 = fs.tile_ladder.launches[variant]
        yk = fs.tile_ladder(variant, **args)
        torch.cuda.synchronize()
        assert fs.tile_ladder.launches[variant] == n0 + 1
        _close_to(yk, fs.tile_ladder_reference(variant, **args))


@pytest.mark.gpu
def test_no_sum_keeps_every_load_and_a_nan_sum_on_card(cuda):
    lad = fs.tile_ladder_inputs(2, device=cuda)
    vals = lad["values"].clone()
    vals[8 * 5 + 6, 9] = float("nan")
    y = fs.tile_ladder("no-sum", **dict(lad, values=vals))
    assert torch.isnan(y[5, 9]) and int(torch.isnan(y).sum()) == 1


@pytest.mark.gpu
def test_bench_fused_stages_on_card(cuda):
    d = FusedDevice.from_packed(_pack("q4")[1], cuda)
    r = fs.bench_fused_stages(d, device=cuda,
                              only=["fwd", "fwd_s1", "blocks", "dev.spmv",
                                    "ladder:no-route"])
    assert list(r) == ["fwd", "fwd_s1", "blocks", "dev.spmv",
                       "ladder:no-route@128", "ladder:no-route@16"]
    for name, ph in r.items():
        assert ph["stream_ms"] > 0 and ph["call_ms"] > 0, name
        assert 0 < ph["bound_ms"] < ph["stream_ms"], name
    assert r["fwd"]["launches"]["fused_forward"] > 100
    assert r["blocks"]["launches"] == {"fused_spmv":
                                       r["blocks"]["launches"]["fused_spmv"]}
    assert r["ladder:no-route@16"]["launches"]["tile_ladder:no-route"] > 100
