"""The fused-redesign prototypes on the card: ``fused_proto`` (its scratch
in shared memory, and past the opt-in in a workspace), ``tile_forward`` at
each GLW and selects-first, and ``streams_sum`` in its four forms, each
against its plain PyTorch version; and ``bench_fused_proto`` at small
shapes.

Imports nothing of JAX, so it runs on the card's machine:
``python -m pytest tests/test_torch_fused_proto_gpu.py -m gpu
--noconftest``; without a card every test skips.  Tolerance: rtol 1e-5,
atol 1e-5 * max(1, max|ref|) (the same f32 terms summed in another order).
"""

import numpy as np
import pytest
import torch

from sparsetpu_torch.bench import fused_proto as fp
from sparsetpu_torch.bench import fused_stages as fs


def _close_to(y, ref):
    y, ref = y.cpu().numpy(), ref.cpu().numpy()
    atol = 1e-5 * max(1.0, float(np.abs(ref).max()) if ref.size else 1.0)
    np.testing.assert_allclose(y, ref, rtol=1e-5, atol=atol)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


# ST 2 and the script's 56 keep the scratch in shared memory; ST 60 (245,760
# B) passes the 232,448 B opt-in, so it goes to a workspace
PROTO_SHAPES = {
    "small": dict(n_slabs=2, st_tiles=16, GL=4, OT=3, x_rows=64),
    "st56": dict(n_slabs=3, st_tiles=448, GL=16, OT=64),
    "st60_workspace": dict(n_slabs=2, st_tiles=480, GL=16, OT=9),
}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", list(PROTO_SHAPES))
def test_fused_proto_matches_plain_on_card(cuda, shape):
    a = fp.fused_proto_inputs(**PROTO_SHAPES[shape], device=cuda)
    form = "global" if shape == "st60_workspace" else "shared"
    n0 = fp.fused_proto.launches[form]
    yk = fp.fused_proto(**a)
    torch.cuda.synchronize()
    assert fp.fused_proto.launches[form] == n0 + 1
    _close_to(yk, fp.fused_proto_reference(**a))
    # inputs past the script's: any cell, any int16 meta, any base
    g = torch.Generator(device=cuda).manual_seed(5)
    n_slabs, ST = a["tile_base"].shape
    wild = dict(
        a, fcell=torch.randint(-4, 8 * ST + 4, a["fcell"].shape, device=cuda,
                               generator=g, dtype=torch.int16),
        meta=torch.randint(-2 ** 15, 2 ** 15, a["meta"].shape, device=cuda,
                           generator=g, dtype=torch.int16),
        tile_base=torch.randint(-3, a["xw"].shape[0] // 8 + 3, (n_slabs, ST),
                                device=cuda, generator=g, dtype=torch.int32))
    _close_to(fp.proto_launch(**wild), fp.fused_proto_reference(**wild))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["small", "st56"])
def test_fused_proto_forced_workspace_on_card(cuda, shape):
    """The scratch in a device-memory workspace where it fits shared
    memory: the same result as the shared form."""
    a = fp.fused_proto_inputs(**PROTO_SHAPES[shape], device=cuda)
    n0 = fp.fused_proto.launches["global"]
    yw = fp.proto_launch(**a, workspace=True)
    torch.cuda.synchronize()
    assert fp.fused_proto.launches["global"] == n0 + 1
    _close_to(yw, fp.fused_proto_reference(**a))
    assert torch.equal(yw, fp.proto_launch(**a))


@pytest.mark.gpu
def test_fused_proto_raises_on_a_bad_cell_on_card(cuda):
    a = fp.fused_proto_inputs(**PROTO_SHAPES["small"], device=cuda)
    bad = a["fcell"].clone()
    bad[3, 4] = 8 * a["tile_base"].shape[1]
    with pytest.raises(ValueError, match="fcell outside"):
        fp.fused_proto(**dict(a, fcell=bad))


@pytest.mark.gpu
@pytest.mark.parametrize("glw", [1, 2, 4, 8, 16])
def test_glw_forward_matches_plain_on_card(cuda, glw):
    a = fp.glw_inputs(glw, n_steps=3, device=cuda)
    n0 = fs.tile_forward.launches[f"full-glw{glw}"]
    yk = fs.tile_forward("full", glw, **a)
    torch.cuda.synchronize()
    assert fs.tile_forward.launches[f"full-glw{glw}"] == n0 + 1
    _close_to(yk, fs.tile_forward_reference("full", glw, **a))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["full", "selfirst"])
def test_selfirst_matches_plain_on_card(cuda, kind):
    lad = fs.tile_ladder_inputs(2, device=cuda)
    for T in (16, 128):
        a = dict(lad, tile_base=lad["tile_base"].view(-1, T))
        n0 = fs.tile_forward.launches[f"{kind}-glw16"]
        yk = fs.tile_forward(kind, 16, **a)
        torch.cuda.synchronize()
        assert fs.tile_forward.launches[f"{kind}-glw16"] == n0 + 1
        _close_to(yk, fs.tile_forward_reference(kind, 16, **a))
    # any int8 cell, signed: the group's bits as the select tree reads them
    g = torch.Generator(device=cuda).manual_seed(9)
    a = dict(lad, i1=torch.randint(-128, 128, lad["i1"].shape, device=cuda,
                                   generator=g, dtype=torch.int8))
    _close_to(fs.tile_forward(kind, 8, **a),
              fs.tile_forward_reference(kind, 8, **a))


@pytest.mark.gpu
@pytest.mark.parametrize("form", list(fp.STREAM_FORMS))
def test_streams_match_plain_on_card(cuda, form):
    for steps in (6, 106):
        a = fp.stream_args(fp.streams_inputs(steps, device=cuda), form)
        n0 = fp.streams_sum.launches[form]
        yk = fp.streams_sum(**a)
        torch.cuda.synchronize()
        assert fp.streams_sum.launches[form] == n0 + 1
        _close_to(yk, fp.streams_sum_reference(**a))


@pytest.mark.gpu
def test_bench_fused_proto_on_card(cuda):
    r = fp.bench_fused_proto(device=cuda, small=True,
                             only=["proto", "glw@4", "selfirst",
                                   "streams@2xS2"])
    assert list(r) == ["proto@3x448", "proto@3x448:workspace", "proto@24x56",
                       "glw@4", "selfirst@A", "selfirst@B", "streams@2xS2"]
    l2 = torch.cuda.get_device_properties(cuda).L2_cache_size
    for name, ph in r.items():
        assert ph["stream_ms"] > 0 and ph["call_ms"] > 0, name
        assert ph["l2_resident"] == (ph["bytes"] <= l2), name
        if ph["l2_resident"]:
            assert ph["bound_ms"] is None, name
        else:
            assert 0 < ph["bound_ms"] < ph["stream_ms"], name
    assert r["proto@3x448"]["launches"] == {"fused_proto:shared": 156}
    assert r["proto@3x448:workspace"]["launches"] == {
        "fused_proto:global": 156}
    assert r["selfirst@B"]["launches"] == {"tile_forward:selfirst-glw16":
                                           156}
    assert r["streams@2xS2"]["launches"] == {"streams_sum:2xS2": 156}
