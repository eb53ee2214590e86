"""The measurement path on the card: every stage of the ladder kernel
(``csrc/micro_ladder.cu``) and the forward kernel #3 at the rate sweep's
inputs, against their plain PyTorch versions.

Imports nothing of JAX, so it runs on the card's machine:
``python -m pytest tests/test_torch_micro_gpu.py -m gpu --noconftest``;
without a card every test skips.  Tolerance: rtol 1e-5, atol 1e-5 *
max(1, max|ref|) (the same f32 terms summed in another order).
"""

import numpy as np
import pytest
import torch

from sparsetpu_torch.bench import micro
from sparsetpu_torch.kernels import spmv_gstream as sg
from sparsetpu_torch.pack import rates

GS = (1, 2, 8, 32)


def _close_to(y, ref):
    y, ref = y.cpu().numpy(), ref.cpu().numpy()
    atol = 1e-5 * max(1.0, float(np.abs(ref).max()) if ref.size else 1.0)
    np.testing.assert_allclose(y, ref, rtol=1e-5, atol=atol)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("T", [16, 7])
def test_every_ladder_stage_matches_plain_on_card(cuda, T):
    inp = micro.ladder_inputs(320, GS, 16, cuda)
    for name, stage, cell, G, _ in micro.ladder_runs(inp, GS):
        args = (stage, inp["val"], inp["idx"], cell, inp["xw"], inp["base"])
        n0 = micro.ladder_stage.launches[name]
        yk = micro.ladder_stage(*args, G=G, T=T)
        torch.cuda.synchronize()
        assert micro.ladder_stage.launches[name] == n0 + 1, name
        _close_to(yk, micro.ladder_reference(*args, G=G, T=T))


@pytest.mark.gpu
def test_ladder_reads_zero_past_the_window_on_card(cuda):
    """Cells past their window and bases past xw read 0 in the kernel as
    in the plain version (the bounds that keep every address in xw)."""
    inp = micro.ladder_inputs(64, (4,), 16, cuda)
    wide = inp["cells"][4]
    base = inp["base"].clone()
    base[::3] = 40                     # past the 32 groups of xw
    for stage, G, cell, b in (("dual", 1, wide, inp["base"]),
                              ("window", 2, wide, inp["base"]),
                              ("window-smem", 2, wide, inp["base"]),
                              ("tilebase", 1, inp["cell"], base)):
        args = (stage, inp["val"], inp["idx"], cell, inp["xw"], b)
        _close_to(micro.ladder_stage(*args, G=G),
                  micro.ladder_reference(*args, G=G))


@pytest.mark.gpu
@pytest.mark.parametrize("G,Q", [(1, 8), (2, 8), (8, 2), (32, 1)])
def test_forward_at_the_rate_inputs_matches_plain_on_card(cuda, G, Q):
    val, xw0, metas = rates.rate_inputs(G, 256)
    val, xw0, meta = (torch.from_numpy(a).to(cuda)
                      for a in (val, xw0, metas[G]))
    sw = torch.zeros(2, dtype=torch.int32, device=cuda)
    ck = sg.gstream_chunk_sums(val, meta, sw, xw0, T=128, G=G, P=8 // Q)
    _close_to(ck, sg.gstream_chunk_sums_reference(val, meta, sw, xw0, T=128,
                                                  G=G, P=8 // Q))


@pytest.mark.gpu
def test_refresh_rates_on_card(cuda, tmp_path, monkeypatch):
    monkeypatch.setenv("SPARSETPU_TORCH_CACHE", str(tmp_path))
    t = rates.refresh_rates(device=cuda, combos=[(2, 8), (8, 2)], n_tiles=1024)
    assert set(t) == {(2, 8), (8, 2)} and all(v > 0 for v in t.values())
    assert rates.load_rates(torch.cuda.get_device_name(cuda)) == t
