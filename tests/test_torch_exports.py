"""The port's public names against the JAX package's: ``__all__`` of the
top level, of ``formats``, ``pack``, ``utils`` and ``bench``.  Every name of
``sparsetpu`` is in ``sparsetpu_torch`` but those listed in ``MISSING``,
each with its reason; the port's additional names are listed too, so that
a name that appears or goes in either package shows here.  Keywords,
members and every other module: ``tests/test_torch_surface.py``."""

import dataclasses
import importlib

import pytest

import sparsetpu
import sparsetpu_torch

# the reference's names the port does not have, and why
MISSING = {
    "DF64": "f64 is native FP64 on the card: a float64 tensor takes the "
            "place of the (hi, lo) pair that carries df64 through jit",
}
# names both packages have that differ in kind, and why
DIFFERENT = {
    "pack": "the port's ``pack`` is the pack function (``pack_matrix``), "
            "which tests/test_torch_api.py calls as ``st.pack(m, ...)``; "
            "the subpackage stays importable as ``sparsetpu_torch.pack``",
}
# the port's own names beyond the reference's: the devices, wrappers and
# solvers the JAX package keeps in its subpackages, and the card's entry
# points
ADDED = {
    "BSRDevice", "CGResult", "DF64FusedDevice", "DF64GStreamDevice",
    "FinalRows", "FusedDevice", "GStreamDevice", "LiveSlots",
    "autotune_candidates", "autotune_pack", "bicgstab", "bsr_partials",
    "bsr_spmv", "bsr_to_csr", "cg", "cg_df64", "cg_step",
    "create_csr_hw_matrix", "create_csr_hw_x_vector", "csr_to_bsr",
    "default_tolerance", "delete_csr_hw_matrix", "delete_csr_hw_x_vector",
    "final_rows", "final_rows_multi", "fused_spmm", "fused_spmv",
    "fused_spmv_f64", "gmres", "gstream_chunk_sums",
    "gstream_chunk_sums_multi", "gstream_chunk_sums_multi_f64",
    "jacobi_iteration", "jacobi_preconditioner", "live_slot_sums", "pcg",
    "pcg_df64", "power_iteration", "spmm_df64", "spmm_gstream", "spmv_hw",
}


def test_top_level_names_match_the_reference():
    ref, port = set(sparsetpu.__all__), set(sparsetpu_torch.__all__)
    assert ref - port == set(MISSING)
    assert port - ref == ADDED
    for name in port:
        assert hasattr(sparsetpu_torch, name), name
    # the subpackages are the port's own
    for name in ("formats", "kernels", "api", "utils"):
        mod = getattr(sparsetpu_torch, name)
        assert mod.__name__ == f"sparsetpu_torch.{name}"
    assert sparsetpu_torch.pack_matrix is sparsetpu_torch.pack
    assert callable(sparsetpu_torch.pack) and set(DIFFERENT) == {"pack"}
    assert sparsetpu_torch.COOMatrix is sparsetpu_torch.formats.COOMatrix


@pytest.mark.parametrize("sub", ["formats", "pack"])
def test_subpackage_names_match_the_reference(sub):
    ref = importlib.import_module(f"sparsetpu.{sub}")
    port = importlib.import_module(f"sparsetpu_torch.{sub}")
    assert set(ref.__all__) == set(port.__all__)
    for name in ref.__all__:
        a, b = getattr(ref, name), getattr(port, name)
        if getattr(a, "__module__", "").startswith("sparsetpu."):
            # the reference's own class or function: the port's copy
            assert b.__module__.startswith("sparsetpu_torch."), name
            assert (a.__name__, type(a)) == (b.__name__, type(b)), name
        else:
            assert a == b, name                 # constants, numpy types


# the port's own names in ``utils`` and ``bench`` beyond the reference's:
# the device rule and the card's facts; the CUDA-event timers
SUB_ADDED = {
    "utils": {"CUDA", "HBM_GBPS", "card_line", "hbm_gbps", "pick_device",
              "require_device"},
    "bench": {"call_ms", "stream_ms"},
}


@pytest.mark.parametrize("sub", ["utils", "bench"])
def test_utils_and_bench_names_match_the_reference(sub):
    ref = importlib.import_module(f"sparsetpu.{sub}")
    port = importlib.import_module(f"sparsetpu_torch.{sub}")
    assert set(port.__all__) - set(ref.__all__) == SUB_ADDED[sub]
    assert set(ref.__all__) <= set(port.__all__)
    for name in ref.__all__:
        a, b = getattr(ref, name), getattr(port, name)
        if isinstance(a, type) or callable(a):
            # the reference's own class or function: the port's copy
            assert b.__module__.startswith("sparsetpu_torch."), name
            assert (a.__name__, type(a)) == (b.__name__, type(b)), name
        elif dataclasses.is_dataclass(a):
            assert type(a).__name__ == type(b).__name__, name
            assert dataclasses.asdict(a) == dataclasses.asdict(b), name
        else:
            assert a == b, name                 # the layout constants
