"""sparsetpu_torch's distributed SpMV on the card: one rank over NCCL (a
real process group of world size 1), against the same rank's plain
results on the CPU over a gloo group.

Imports nothing of JAX, so it runs on the card's machine:
``python -m pytest tests/test_torch_dist_gpu.py -m gpu --noconftest``;
without a card every test skips.  Tolerances: f32 y against the plain y
rtol 1e-5, atol 1e-5 * max(1, max|y|) (the same sums in another order);
f64 y rtol 1e-12, atol 1e-12 * max(1, max|y|), and against the gold at
1e-10 * max(1, max|y|).
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from sparsetpu_torch import _host
from sparsetpu_torch.dist import (make_mesh, ring_shard_spmv, run_ranks,
                                  shard_spmv, shard_spmv_df64)
from sparsetpu_torch.kernels.final_rows import final_rows
from sparsetpu_torch.kernels.spmv_gstream import (gstream_chunk_sums,
                                                  live_slot_sums)


def _mats():
    return {"f32": _host.random_csr(3000, 20000, density=0.004, seed=22,
                                    dtype=np.float32),
            "f64": _host.random_csr(600, 800, density=0.02, seed=11,
                                    dtype=np.float64)}


def _launches():
    f = final_rows.launches
    return (gstream_chunk_sums.launches["window"],
            f["short"] + f["long"], live_slot_sums.launches,
            f["short_f64"] + f["long_f64"])


def _rank(rank, world, device):
    """Each schedule on the card (NCCL) and on the CPU (a gloo group of the
    same rank), with the card's launch counts."""
    mats = _mats()
    cuda, cpu = make_mesh(world), dist.new_group(backend="gloo")
    x32 = np.random.default_rng(5).standard_normal(mats["f32"].nr_cols)
    x64 = np.random.default_rng(5).standard_normal(mats["f64"].nr_cols)
    out = {}
    for name, build, m, x in (
            ("allgather", shard_spmv, mats["f32"], x32),
            ("ring", ring_shard_spmv, mats["f32"], x32),
            ("df64", shard_spmv_df64, mats["f64"], x64)):
        before = _launches()
        y = build(m, cuda, device=device).spmv(x)
        torch.cuda.synchronize()
        out[name] = {"y": y.cpu().numpy(),
                     "launches": [a - b for a, b in zip(_launches(), before)],
                     "plain": build(m, cpu, device="cpu").spmv(x).numpy()}
    return out


@pytest.fixture(scope="module")
def results():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return run_ranks(_rank, 1, "nccl", device="cuda", timeout=600)[0]


def _agree(y, ref, rtol):
    atol = rtol * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(y, ref, rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ("allgather", "ring"))
def test_f32_schedules_on_the_card_meet_their_plain_results(results, name):
    got, m = results[name], _mats()["f32"]
    _agree(got["y"], got["plain"], 1e-5)
    x = np.random.default_rng(5).standard_normal(m.nr_cols)
    atol, rtol = _host.default_tolerance(np.float32,
                                         m.nr_nzeros / m.nr_rows)
    assert _host.verification(_host.spmv_gold(m, x), got["y"], atol,
                              rtol) == 0
    window, final, _, _ = got["launches"]
    assert window >= 1 and final >= 1


@pytest.mark.gpu
def test_df64_on_the_card_meets_its_plain_result_and_the_gold(results):
    got, m = results["df64"], _mats()["f64"]
    _agree(got["y"], got["plain"], 1e-12)
    x = np.random.default_rng(5).standard_normal(m.nr_cols)
    err = np.abs(got["y"] - _host.spmv_gold(m, x)).max()
    assert err <= 1e-10 * max(1.0, np.abs(got["y"]).max())
    _, _, live, final64 = got["launches"]
    assert live == 1 and final64 >= 1
