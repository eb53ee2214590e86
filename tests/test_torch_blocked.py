"""sparsetpu_torch's reference-parity stream (``pack/blocked.py``) and debug
dumps (``utils/debug.py``) against the JAX package's.

The cases of ``tests/test_blocked.py`` and of
``tests/test_misc.py::test_dump_tiles_and_stats`` go through both
packages on the same numpy inputs; every output must be byte-identical:
``pack_blocked``'s streams, bitmaps and partitions, ``unpack_stream``,
``write_hw_x_vector``, ``print_wide``, ``dump_tiles`` and ``format_stats``
text, and ``spmv_blocked_emulated``'s y, which also meets the gold (f64:
1e-5, f32: 1e-3, as ``test_blocked.py`` holds it).
"""

import io

import numpy as np
import pytest

from sparsetpu.formats.csr import CSRMatrix as JaxCSRMatrix
from sparsetpu.pack import blocked as jb
from sparsetpu.pack.gather_stream import pack_gstream as jax_pack_gstream
from sparsetpu.utils import debug as jdebug
from sparsetpu.utils.config import SpmvConfig as JaxSpmvConfig

from sparsetpu_torch import _host
from sparsetpu_torch.pack import blocked as pb
from sparsetpu_torch.utils import debug as pdebug
from test_torch_fused import native_engines_first  # noqa: F401 (autouse)


def _jax_csr(m):
    return JaxCSRMatrix(m.row_ptr, m.col_ind, m.values, m.nr_rows,
                        m.nr_cols)


def _same_hw(a, b):
    """Two ``BlockedHwMatrix`` hold the same streams, bitmaps, partitions
    and scalars, byte for byte."""
    assert (a.nr_rows, a.nr_cols, a.nr_nzeros, a.block_cols, a.vf,
            a.dtype) == (b.nr_rows, b.nr_cols, b.nr_nzeros, b.block_cols,
                         b.vf, b.dtype)
    for name in ("empty_rows_bitmap", "part_row_start", "part_row_end"):
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), name
    assert (a.num_partitions, a.nr_blocks) == (b.num_partitions,
                                               b.nr_blocks)
    for ra, rb in zip(a.submatrices, b.submatrices):
        for sa, sb in zip(ra, rb):
            assert sa.stream.dtype == sb.stream.dtype
            assert sa.stream.tobytes() == sb.stream.tobytes()
            assert (sa.nr_rows, sa.nr_nzeros, sa.nr_ci, sa.nr_val) == \
                (sb.nr_rows, sb.nr_nzeros, sb.nr_ci, sb.nr_val)
    assert a.storage_bytes() == b.storage_bytes()
    assert a.storage_overhead() == b.storage_overhead()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_stream_period(dtype):
    assert pb._ratio_col_val(dtype) == jb._ratio_col_val(dtype)
    assert pb._ratio_v(dtype) == jb._ratio_v(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("partitions,vf", [(1, 1), (2, 4), (4, 8), (12, 8)])
def test_blocked_pack_and_emulated_spmv_match_jax(dtype, partitions, vf):
    m = _host.random_csr(300, 40000, density=0.003, seed=40, dtype=dtype,
                         empty_row_frac=0.2)  # 2 column blocks at 32768
    hw = pb.pack_blocked(m, _host.SpmvConfig(
        dtype=dtype, vf=vf, num_partitions=partitions))
    jhw = jb.pack_blocked(_jax_csr(m), JaxSpmvConfig(
        dtype=dtype, vf=vf, num_partitions=partitions))
    assert hw.nr_blocks == 2 and hw.num_partitions == partitions
    _same_hw(hw, jhw)
    x = np.random.default_rng(1).standard_normal(m.nr_cols).astype(dtype)
    y = pb.spmv_blocked_emulated(hw, x)
    assert y.tobytes() == jb.spmv_blocked_emulated(jhw, x).tobytes()
    tol = 1e-5 if dtype == np.float64 else 1e-3
    assert _host.verification(_host.spmv_gold(m, x), y, diff_thres=tol,
                              rel_thres=tol) == 0


def test_bit_layout_unpack_and_print_wide_match_jax():
    """test_blocked_bit_layout's matrix: the streams, their unpacking and
    ``print_wide``'s text."""
    rows = np.array([0, 0, 1])
    cols = np.array([5, 700, 32768 + 9])  # block 0 and block 1
    vals = np.array([1.0, 2.0, 3.0])
    m = _host.CSRMatrix.from_coo(rows, cols, vals, 2, 40000)
    hw = pb.pack_blocked(m, _host.SpmvConfig(dtype=np.float64, vf=1))
    jhw = jb.pack_blocked(_jax_csr(m), JaxSpmvConfig(dtype=np.float64,
                                                     vf=1))
    _same_hw(hw, jhw)
    f64 = np.dtype(np.float64)
    for sub, jsub in zip(hw.submatrices[0], jhw.submatrices[0]):
        for a, b in zip(pb.unpack_stream(sub, f64),
                        jb.unpack_stream(jsub, f64)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        for words in (16, 1, 3):
            assert pb.print_wide(sub, f64, words) == \
                jb.print_wide(jsub, f64, words)
    local, eor, v = pb.unpack_stream(hw.submatrices[0][1], f64)
    assert local[0] == 9 and eor[0] and v[0] == 3.0
    assert "*" in pb.print_wide(hw.submatrices[0][0], f64)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_write_hw_x_vector_matches_jax(dtype):
    x = np.arange(5, dtype=dtype)
    for blocks, cols in ((2, 4), (1, 5), (3, 2)):
        a = pb.write_hw_x_vector(x, blocks, cols, dtype)
        b = jb.write_hw_x_vector(x, blocks, cols, dtype)
        assert a.shape == b.shape == (blocks, cols)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("start,count,lanes", [(0, 1, 4), (1, 3, 8),
                                               (0, 2, 128)])
def test_dump_tiles_and_stats_match_jax(start, count, lanes):
    """test_dump_tiles_and_stats's matrix and pack: the same text from both
    packages, printed and returned."""
    m = _host.random_csr(40, 60, density=0.2, seed=4, dtype=np.float32)
    p = _host.pack_gstream(m)
    jp = jax_pack_gstream(_jax_csr(m))
    out, jout = io.StringIO(), io.StringIO()
    text = pdebug.dump_tiles(p, start, count, lanes=lanes, file=out)
    assert text == jdebug.dump_tiles(jp, start, count, lanes=lanes,
                                     file=jout)
    assert out.getvalue() == jout.getvalue() == text + "\n"
    assert "tile 0" in pdebug.dump_tiles(p, 0, 1, lanes=4, file=out)
    assert pdebug.format_stats(p) == jdebug.format_stats(jp)
    assert "fill=" in pdebug.format_stats(p)
