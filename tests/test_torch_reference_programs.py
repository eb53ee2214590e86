"""Programs written for the reference, run on the port.

Each program is written as a user of ``sparsetpu`` writes it, as a function
of the package ``S``; it runs once with ``S = sparsetpu`` and once with
``S = sparsetpu_torch`` on the same numpy inputs from seeds, and the results
are compared.  Each passes ``interpret=True``, as ``bench.py`` does off the
TPU: Pallas interpret mode in the JAX package, the plain PyTorch versions
on the CPU in the port.  ``_np`` (here, not in the programs) turns a
``jax.Array`` or a tensor into numpy.

  bench.py   ``bench.py:84-92`` without its timing: ``SparseMatrix(m,
             backend="pallas")``, its ``_device``, ``prepare_x`` and
             ``spmv(x2, x_is_packed=True)``, ``verification`` against
             ``spmv_gold``;
  recipe     the JAX drive recipe of ``.claude/skills/verify/SKILL.md``:
             ``SparseMatrix(m).spmv(x)`` on an f64 matrix;
  classic    ``GStreamDevice(pack_gstream(m), interpret=True,
             finish_levels=None)``: ``spmv`` and ``spmm_gstream(dev,
             x_multi=X)`` at k = 3;
  f64        ``pack_fused_df64(m, interpret=True).spmv_f64(x)``,
             ``DF64GStreamDevice(m, interpret=True).spmv_f64(x)``,
             ``spmm_df64(dev, x_multi=X)`` and ``spmv_f64_emulated``;
  CLI        ``main(["--backend", "pallas", "-v", ...])`` and ``--backend
             xla`` (``--device cpu`` on the port's side only): both exit 0
             and verify.

Tolerance: f32 results agree within the gold's (``default_tolerance`` at
the matrix's mean row length) and meet the gold; f64 results agree within
1e-10 * max(1, max|y|).  Then the port's own rules: ``interpret=True``
with a named CUDA device raises, a device passed where the reference has
``interpret`` raises, nothing runs on the CPU unless asked; the
distributed entry points with ``interpret=True`` over a gloo group of one
rank, rendezvous at ``init_multihost``'s ``coordinator_address``.
"""

import contextlib
import importlib
import io
import socket

import numpy as np
import pytest
import torch

import sparsetpu
import sparsetpu_torch
from sparsetpu_torch import _host
from sparsetpu_torch.formats.gold import spmm_gold
from sparsetpu_torch.utils.device import CUDA, pick_device

PACKAGES = (sparsetpu, sparsetpu_torch)


def _mod(S, name):
    return importlib.import_module(f"{S.__name__}.{name}")


def _np(y):
    """A jax.Array, a tensor or an array as a numpy array."""
    if isinstance(y, torch.Tensor):
        return y.detach().cpu().numpy()
    return np.asarray(y)


def _f32_agree(m, a, b):
    atol, rtol = _host.default_tolerance(
        np.float32, m.nr_nzeros / max(m.nr_rows, 1))
    assert a.shape == b.shape
    assert _host.verification(a, b, diff_thres=atol, rel_thres=rtol) == 0


def _f64_agree(a, b):
    assert a.dtype == b.dtype == np.float64 and a.shape == b.shape
    assert np.abs(a - b).max() <= 1e-10 * max(1.0, np.abs(a).max())


# ---------------------------------------------------------------------------
# the programs
# ---------------------------------------------------------------------------

def bench_protocol(S):
    """bench.py:84-92, without its timing, at a CPU size."""
    random_csr = _mod(S, "formats.random").random_csr
    gold = _mod(S, "formats.gold")
    SparseMatrix = _mod(S, "api.api").SparseMatrix
    m = random_csr(1000, 600, density=0.01, seed=1, dtype=np.float32)
    sm = SparseMatrix(m, backend="pallas", interpret=True)
    d = sm._device
    x = np.random.default_rng(0).standard_normal(m.nr_cols)
    x2 = d.prepare_x(x)
    y = np.asarray(d.spmv(x2, x_is_packed=True))
    errors = gold.verification(gold.spmv_gold(m, x), y, diff_thres=1e-2,
                               rel_thres=1e-3)
    return m, y, errors


def drive_recipe(S):
    """The JAX drive recipe of the verify notes, at a CPU size."""
    SparseMatrix, spmv_gold, verification = (
        S.SparseMatrix, S.spmv_gold, S.verification)
    m = S.formats.random_csr(300, 400, density=0.02, seed=42)  # f64
    x = np.random.default_rng(7).standard_normal(m.nr_cols)
    sm = SparseMatrix(m, interpret=True)
    y = np.asarray(sm.spmv(x))        # float64 result
    return y, verification(spmv_gold(m, x), y, 1e-5, 1e-5)


def classic_device(S):
    """The classic device and its SpMM, as the JAX tests drive them."""
    m = S.formats.random_csr(300, 2000, density=0.01, seed=3,
                             dtype=np.float32)
    p = _mod(S, "pack.gather_stream").pack_gstream(m)
    dev = S.kernels.GStreamDevice(p, interpret=True, finish_levels=None)
    x = np.random.default_rng(4).standard_normal(m.nr_cols)
    X = np.random.default_rng(5).standard_normal((m.nr_cols, 3))
    y = dev.spmv(x)
    Y = _mod(S, "kernels.spmm").spmm_gstream(dev, x_multi=X)
    return m, x, X, y, Y


def f64_devices(S):
    """Both f64 devices and the user-level f64 SpMV."""
    f64emu = _mod(S, "kernels.f64emu")
    m = S.formats.random_csr(300, 400, density=0.02, seed=5)      # f64
    x = np.random.default_rng(9).standard_normal(m.nr_cols)
    X = np.random.default_rng(10).standard_normal((m.nr_cols, 2))
    fused = _mod(S, "kernels.spmv_fused").pack_fused_df64(m, interpret=True)
    classic = f64emu.DF64GStreamDevice(m, interpret=True)
    emulated = (f64emu.spmv_f64_emulated(m, x) if S is sparsetpu else
                f64emu.spmv_f64_emulated(m, x, device="cpu"))
    return (m, x, X, fused.spmv_f64(x), classic.spmv_f64(x),
            f64emu.spmm_df64(classic, x_multi=X), emulated)


def cli(S, backend):
    argv = ["--backend", backend, "-v", "--random", "300x400x0.02"]
    if S is sparsetpu_torch:
        argv += ["--device", "cpu"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = _mod(S, "cli").main(argv)
    return rc, out.getvalue()


# ---------------------------------------------------------------------------
# both packages, compared
# ---------------------------------------------------------------------------

def test_bench_protocol():
    (m, yj, ej), (_, yp, ep) = (bench_protocol(S) for S in PACKAGES)
    assert ej == ep == 0
    assert yj.dtype == yp.dtype == np.float32
    _f32_agree(m, yj, yp)


def test_drive_recipe():
    (yj, ej), (yp, ep) = (drive_recipe(S) for S in PACKAGES)
    assert ej == ep == 0
    _f64_agree(yj, yp)


def test_classic_device():
    (m, x, X, yj, Yj), (_, _, _, yp, Yp) = (classic_device(S)
                                            for S in PACKAGES)
    assert isinstance(yp, torch.Tensor) and yp.device.type == "cpu"
    _f32_agree(m, _np(yj), _np(yp))
    _f32_agree(m, _host.spmv_gold(m, x).astype(np.float32), _np(yp))
    Yj, Yp, G = _np(Yj), _np(Yp), spmm_gold(m, X)
    assert Yp.shape == (m.nr_rows, 3)
    for j in range(3):
        _f32_agree(m, Yj[:, j], Yp[:, j])
        _f32_agree(m, G[:, j].astype(np.float32), Yp[:, j])


def test_f64_devices():
    res = [f64_devices(S) for S in PACKAGES]
    m, x, X = res[0][:3]
    gold, Gm = _host.spmv_gold(m, x), spmm_gold(m, X)
    for a, b in zip(res[0][3:], res[1][3:]):
        a, b = _np(a), _np(b)
        _f64_agree(a, b)
        _f64_agree(gold if b.ndim == 1 else Gm, b)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_cli(backend):
    (rj, oj), (rp, op) = (cli(S, backend) for S in PACKAGES)
    assert rj == rp == 0
    for out in (oj, op):
        assert f"backend={backend}" in out
        assert "Verification: PASS (0 errors)" in out


# ---------------------------------------------------------------------------
# the port's rules
# ---------------------------------------------------------------------------

def test_interpret_picks_the_cpu_and_no_card_is_assumed():
    m = _host.random_csr(200, 300, density=0.02, seed=1, dtype=np.float32)
    assert pick_device(CUDA, True) == torch.device("cpu")
    assert pick_device("cpu", True) == torch.device("cpu")
    assert pick_device("cpu", False) == torch.device("cpu")
    sm = sparsetpu_torch.SparseMatrix(m, None, "xla", True)
    assert sm.device.type == "cpu" and sm.backend == "coo"
    sm = sparsetpu_torch.pack(m, backend="pallas", interpret=True)
    assert sm.device.type == "cpu" and sm.backend == "auto"
    assert sm.fused_device is not None
    for dev in ("cuda", "cuda:0", torch.device("cuda")):
        with pytest.raises(ValueError, match="interpret=True"):
            sparsetpu_torch.SparseMatrix(m, interpret=True, device=dev)
    p = _host.pack_gstream(m)
    with pytest.raises(TypeError, match="interpret must be a bool"):
        sparsetpu_torch.GStreamDevice(p, "cpu")
    if not torch.cuda.is_available():
        # the default is the card: without one, nothing runs on the CPU
        for call in (lambda: sparsetpu_torch.SparseMatrix(m),
                     lambda: sparsetpu_torch.GStreamDevice(p),
                     lambda: sparsetpu_torch.FusedDevice(
                         _host.pack_fused(m)),
                     lambda: sparsetpu_torch.SparseMatrix(m, interpret=False)):
            with pytest.raises(RuntimeError, match="is_available"):
                call()


def test_fused_device_from_a_pack_and_from_packed():
    m = _host.random_csr(400, 700, density=0.02, seed=2, dtype=np.float32)
    x = np.random.default_rng(1).standard_normal(m.nr_cols)
    p = _host.pack_fused(m)
    a = sparsetpu_torch.FusedDevice(p, interpret=True).spmv(x)
    b = sparsetpu_torch.FusedDevice.from_packed(p, "cpu").spmv(x)
    assert torch.equal(a, b)
    _f32_agree(m, _host.spmv_gold(m, x).astype(np.float32), a.numpy())


def test_timers_of_the_reference():
    micro = _mod(sparsetpu_torch, "bench.micro")
    assert micro.timeit(lambda: None, 3, 1, device="cpu") >= 0
    xw = torch.zeros(8)
    assert micro.timeit_chained(lambda v: v + 1, xw, 12, 4, 3) > 0
    with pytest.raises(ValueError):
        micro.timeit_chained(lambda v: v, xw, 4, 4)


def _dist_programs():
    from sparsetpu_torch import dist as D
    m = _host.random_csr(600, 900, density=0.01, seed=6, dtype=np.float32)
    x = np.random.default_rng(2).standard_normal(m.nr_cols)
    out = {}
    for name, make in (("allgather", D.shard_spmv),
                       ("ring", D.ring_shard_spmv),
                       ("auto", D.shard_spmv_auto)):
        sh = make(m, interpret=True)
        out[name] = (sh.num_partitions, sh.spmv(x))
    m64 = _host.random_csr(600, 900, density=0.01, seed=7)
    sh = D.shard_spmv_df64(m64, interpret=True)
    out["f64"] = (sh.num_partitions, sh.spmv(x))
    return m, m64, x, out


def test_dist_entry_points_take_interpret():
    import torch.distributed as tdist
    from sparsetpu_torch.dist import init_multihost
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    init_multihost(f"127.0.0.1:{port}", 1, 0, backend="gloo")
    try:
        assert tdist.get_world_size() == 1 and tdist.get_rank() == 0
        m, m64, x, out = _dist_programs()
    finally:
        tdist.destroy_process_group()
    for name, (n, y) in out.items():
        assert n == 1 and y.device.type == "cpu", name
        if name == "f64":
            _f64_agree(_host.spmv_gold(m64, x), _np(y))
        else:
            _f32_agree(m, _host.spmv_gold(m, x).astype(np.float32), _np(y))
