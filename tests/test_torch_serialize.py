"""sparsetpu_torch's checkpoints (``pack/serialize.py``) against the JAX
package's.

For each device kind the reference can save, the same pack goes to the
port's device (CPU tensors, the kernels' plain versions) and to the JAX
device (Pallas interpret mode), and each is saved:

  archive   the port's archive equals the JAX archive key by key: the same
            keys, dtypes, shapes and bytes (the f64 lo planes, which the
            port takes from its float64 plane, bit for bit);
  load      the port loads the JAX archive without packing or building a
            finish (both monkeypatched to raise), and its y equals the
            original device's bit for bit; the JAX ``load_device`` loads
            the port's archive, and the two ys agree (f32: rtol 1e-5, atol
            1e-5 * max(1, max|y|); f64: 1e-11 * max(1, max|y|), but the
            JAX f64 segment-sum route's, which rounds in f32: 1e-5) and
            meet the gold (f64: within 1e-10 * max(1, max|y|)).

Beyond the reference: a classic device whose final is a
``_FinalLevelMulti`` round-trips in the port, where the JAX ``save_device``
raises ``AttributeError`` (ROADMAP Queue 3); a bf16 device is refused,
where the JAX archive of one cannot be loaded.  The host half
(``save_gstream``/``save_fused``) crosses over both ways, old archives
included.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sparsetpu.formats.csr import CSRMatrix as JaxCSRMatrix
from sparsetpu.kernels import f64emu as jf
from sparsetpu.kernels import spmv_fused as jfu
from sparsetpu.kernels import spmv_pallas as jsp
from sparsetpu.pack import serialize as jser

from sparsetpu_torch import _host
from sparsetpu_torch.kernels import f64emu as pf
from sparsetpu_torch.kernels import spmv_fused as sf
from sparsetpu_torch.kernels import spmv_gstream as sg
from sparsetpu_torch.kernels.final_rows import FinalRows
from sparsetpu_torch.pack import fused as pfused
from sparsetpu_torch.pack import final_levels as fl
from sparsetpu_torch.pack import gather_stream as pgs
from sparsetpu_torch.pack import serialize as ser
from test_torch_fused import native_engines_first  # noqa: F401 (autouse)
from test_torch_gstream import _heavy_matrix

F64_REL = 1e-11          # port vs JAX f64 y, relative to max(1, max|y|)
F64_GOLD_REL = 1e-10     # f64 y vs the gold


def _jax_csr(m):
    return JaxCSRMatrix(m.row_ptr, m.col_ind, m.values, m.nr_rows,
                        m.nr_cols)


def _small(dtype=np.float32):
    return _host.random_csr(300, 2000, density=0.01, seed=3, dtype=dtype)


def _no_final_builds(monkeypatch):
    """No final level builds, in either package: the segment-sum route."""
    none = classmethod(lambda cls, *a, **k: None)
    for mod in (fl, jsp):
        monkeypatch.setattr(mod._FinalLevel, "build", none)
        monkeypatch.setattr(mod._FinalLevelV2, "build", none)


def _devices(kind, monkeypatch):
    """(matrix, the port's device, the JAX device) of one device kind, from
    one pack (the two packages' packs are byte-identical)."""
    if kind in ("classic_f64", "classic_f64_segment_sum"):
        m = _small(np.float64)
        with monkeypatch.context() as mp:
            if kind.endswith("segment_sum"):
                _no_final_builds(mp)
            return (m, pf.DF64GStreamDevice(m, "cpu"),
                    jf.DF64GStreamDevice(_jax_csr(m), interpret=True))
    if kind == "fused_f64":
        m = _small(np.float64)
        ph, pl = sf.pack_fused_df64(m)
        return (m, sf.DF64FusedDevice.from_packed(ph, pl, "cpu"),
                jfu.DF64FusedDevice(ph, pl, interpret=True))
    if kind == "fused":
        m = _small()
        p = _host.pack_fused(m)
        return m, sf.FusedDevice.from_packed(p, "cpu"), jfu.FusedDevice(
            p, interpret=True)
    m = _heavy_matrix() if kind == "flevels" else _small()
    kw = {"legacy": dict(shuffle_lanes=True),
          "flat": dict(shuffle_lanes=False),
          "gl_segment_sum": dict(G=8, GL=2),
          "flevels": {}}[kind]
    p = _host.pack_gstream(m, **kw)
    with monkeypatch.context() as mp:
        if kind == "gl_segment_sum":
            _no_final_builds(mp)
        return m, sg.GStreamDevice(p, "cpu"), jsp.GStreamDevice(
            p, interpret=True)


def _same_archive(path_a, path_b):
    """The two archives hold the same keys, and under each the same dtype,
    shape and bytes."""
    with np.load(path_a) as a, np.load(path_b) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            x, y = a[k], b[k]
            assert (x.dtype, x.shape) == (y.dtype, y.shape), k
            assert x.tobytes() == y.tobytes(), k


def _refuse_builds(monkeypatch):
    """The pack engines and every finish builder raise when called."""
    def boom(*a, **k):
        raise AssertionError("load_device packed or built a finish")
    for mod, name in ((pgs, "pack_gstream"), (_host, "pack_gstream"),
                      (pfused, "pack_fused"), (_host, "pack_fused"),
                      (fl, "build_finish"), (sg, "build_finish")):
        monkeypatch.setattr(mod, name, boom)
    for cls in (fl._FinalLevel, fl._FinalLevelV2, fl._FinalLevelMulti):
        monkeypatch.setattr(cls, "build", classmethod(boom))


def _jax_y(d, x):
    if isinstance(d, (jf.DF64GStreamDevice, jfu.DF64FusedDevice)):
        return jf.join_f64(*(np.asarray(a) for a in d.spmv(x)))
    return np.asarray(d.spmv(x))


def _agree(m, x, y, ref, ref_in_f32=False):
    """y against the JAX device's y and the gold.  ``ref_in_f32``: the
    JAX f64 segment-sum route rounds in f32 (ROADMAP Queue 3), so its y is
    held at the f32 tolerance, the port's y to the gold in f64."""
    if y.dtype == np.float64:
        scale = max(1.0, float(np.abs(ref).max()))
        assert np.abs(y - ref).max() <= (1e-5 if ref_in_f32
                                         else F64_REL) * scale
        gold = _host.spmv_gold(m, x)
        assert np.abs(y - gold).max() <= F64_GOLD_REL * max(
            1.0, float(np.abs(y).max()))
        tol = _host.default_tolerance(np.float64,
                                      m.nr_nzeros / max(m.nr_rows, 1))
    else:
        atol = 1e-5 * max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(y, ref, rtol=1e-5, atol=atol)
        tol = _host.default_tolerance(np.float32,
                                      m.nr_nzeros / max(m.nr_rows, 1))
    assert _host.verification(_host.spmv_gold(m, x), y, *tol) == 0


KINDS = ["legacy", "flat", "gl_segment_sum", "flevels", "fused",
         "fused_f64", "classic_f64", "classic_f64_segment_sum"]


@pytest.mark.parametrize("kind", KINDS)
def test_archive_matches_jax_and_loads_both_ways(kind, tmp_path,
                                                 monkeypatch):
    m, dev, jdev = _devices(kind, monkeypatch)
    if kind == "flevels":
        assert len(dev.plan.flevels) and len(jdev.finish)
    if kind.endswith("segment_sum"):
        assert dev.final is None and jdev.final is None
    port_path, jax_path = str(tmp_path / "port.npz"), str(tmp_path / "j.npz")
    ser.save_device(port_path, dev)
    jser.save_device(jax_path, jdev)
    _same_archive(port_path, jax_path)

    x = np.random.default_rng(5).standard_normal(m.nr_cols)
    with monkeypatch.context() as mp:
        _refuse_builds(mp)
        d2 = ser.load_device(jax_path, device="cpu")
    assert type(d2) is type(dev)
    y = d2.spmv(x).numpy()
    assert y.tobytes() == dev.spmv(x).numpy().tobytes()
    if isinstance(dev, sg.GStreamDevice):
        assert type(d2.final) is type(dev.final)
        assert len(d2.flevels) == len(dev.flevels)
    if type(dev) is sg.GStreamDevice:
        # the f64 archive keeps no ``ordered`` (its final is legacy)
        assert d2.meta.ordered == dev.meta.ordered
    jd2 = jser.load_device(port_path, interpret=True)
    assert type(jd2) is type(jdev)
    _agree(m, x, y, _jax_y(jd2, x),
           ref_in_f32=kind == "classic_f64_segment_sum")


@pytest.mark.parametrize("kind", ["classic", "fused_f64"])
def test_spills_cross_over(kind, tmp_path):
    """Finals and fused packs that spill: the spill arrays (``fin_spill_*``,
    ``spill_*`` and the lo spill values ``df64_spill_vlo``) equal the JAX
    archive's, the port's reload gives the same y bit for bit and meets the
    gold, and the JAX package loads the port's archive with the same
    spills.  (The JAX f64 fused device keeps one spill a row, ROADMAP
    Queue 3, so its y is not compared here.)"""
    if kind == "classic":
        m = _host.random_csr(1000, 300_000, 40 / 300_000, seed=1,
                             dtype=np.float32)
        p = _host.pack_gstream(m, G=4, Q=8, shuffle_lanes=False)
        dev = sg.GStreamDevice(p, "cpu")
        jdev = jsp.GStreamDevice(p, interpret=True)
        assert isinstance(dev.plan.final, fl._FinalLevel)
        assert dev.plan.final.n_spills > 50
        spill_key = "fin_spill_pos"
    else:
        m = _small(np.float64)
        ph, pl = sf.pack_fused_df64(m, use_native=False)
        assert ph.spill_row.size > 500
        dev = sf.DF64FusedDevice.from_packed(ph, pl, "cpu")
        jdev = jfu.DF64FusedDevice(ph, pl, interpret=True)
        spill_key = "df64_spill_vlo"
    port_path, jax_path = str(tmp_path / "port.npz"), str(tmp_path / "j.npz")
    ser.save_device(port_path, dev)
    jser.save_device(jax_path, jdev)
    _same_archive(port_path, jax_path)
    with np.load(port_path) as z:
        assert spill_key in z
    d2 = ser.load_device(jax_path, device="cpu")
    x = np.random.default_rng(5).standard_normal(m.nr_cols)
    y = d2.spmv(x).numpy()
    assert y.tobytes() == dev.spmv(x).numpy().tobytes()
    tol = _host.default_tolerance(y.dtype, m.nr_nzeros / m.nr_rows)
    assert _host.verification(_host.spmv_gold(m, x), y, *tol) == 0
    jd2 = jser.load_device(port_path, interpret=True)
    if kind == "classic":
        assert np.array_equal(np.asarray(jd2.final.spill_pos),
                              dev.plan.final.spill_pos)
    else:
        assert np.array_equal(np.asarray(jd2.spill_vl), pl.spill_val)


def test_lo_plane_is_the_split_of_the_joined_plane():
    """The f64 devices hold hi + lo as one float64 plane; the lo plane the
    archive writes from it is the pack's lo plane bit for bit."""
    m = _small(np.float64)
    ph, pl = pf.pack_gstream_df64(m)
    d = pf.DF64GStreamDevice.from_packed(ph, pl, "cpu")
    lo = ser._lo_plane(d.stream.values, ph.values)
    assert lo.dtype == np.float32 and lo.tobytes() == pl.values.tobytes()


def test_multi_final_round_trips_where_the_reference_raises(tmp_path):
    """Past 8 column blocks the flat final is a ``_FinalLevelMulti``: the
    port saves one ``fin{j}_*`` group a level and loads it back to the same
    y; the JAX ``save_device`` raises ``AttributeError`` on such a device
    (``sparsetpu/pack/serialize.py:151``), and its ``load_device`` cannot
    read the port's archive (ROADMAP Queue 3)."""
    m = _host.random_csr(600, 400_000, density=0.0002, seed=4,
                         dtype=np.float32)
    p = _host.pack_gstream(m)
    assert p.sections.shape[0] > 8
    dev = sg.GStreamDevice(p, "cpu")
    assert isinstance(dev.plan.final, fl._FinalLevelMulti)
    path = str(tmp_path / "multi.npz")
    ser.save_device(path, dev)
    n = len(dev.plan.final.levels)
    with np.load(path) as z:
        assert int(z["fin_levels"][0]) == n
        assert all(f"fin{j}_static_v2" in z for j in range(n))
    d2 = ser.load_device(path, device="cpu")
    assert isinstance(d2.final, sg.FinalMultiDevice)
    assert [type(lvl) for lvl in d2.plan.final.levels] == \
        [fl._FinalLevelV2] * n
    x = np.random.default_rng(5).standard_normal(m.nr_cols)
    y = d2.spmv(x).numpy()
    assert y.tobytes() == dev.spmv(x).numpy().tobytes()
    tol = _host.default_tolerance(np.float32, m.nr_nzeros / m.nr_rows)
    assert _host.verification(_host.spmv_gold(m, x), y, *tol) == 0

    jdev = jsp.GStreamDevice(p, interpret=True)
    assert isinstance(jdev.final, jsp._FinalLevelMulti)
    with pytest.raises(AttributeError, match="step_meta"):
        jser.save_device(str(tmp_path / "j.npz"), jdev)
    with pytest.raises(KeyError, match="fallback_chunk_row"):
        jser.load_device(path, interpret=True)


def test_bf16_device_is_refused(tmp_path):
    """The JAX archive of a bf16 device holds its values as raw 2-byte
    voids, which its own ``load_device`` cannot read; the port refuses to
    save such a device, and to load such an archive."""
    p = _host.pack_gstream(_small())
    with pytest.raises(ValueError, match="bf16"):
        ser.save_device(str(tmp_path / "p.npz"),
                        sg.GStreamDevice(p, "cpu", torch.bfloat16))
    path = str(tmp_path / "j.npz")
    jser.save_device(path, jsp.GStreamDevice(p, interpret=True,
                                             value_dtype=jnp.bfloat16))
    with np.load(path) as z:
        assert z["values"].dtype == np.dtype("V2")
    with pytest.raises(TypeError, match="V2"):
        jser.load_device(path, interpret=True)
    with pytest.raises(ValueError, match="bf16"):
        ser.load_device(path, device="cpu")


@pytest.mark.parametrize("what", ["object", "band_map", "f64_band_map"])
def test_save_device_rejects_what_it_cannot_save(what, tmp_path):
    """Anything but the four devices, and a device whose final is a map
    with no host level behind it (a rank's band), raises TypeError."""
    p = _host.pack_gstream(_small())
    if what == "object":
        device = object()
    elif what == "band_map":
        rows = FinalRows.from_chunk_row(p.chunk_row, p.nr_rows, "cpu")
        device = sg.GStreamDevice(p, "cpu",
                                  plan=fl.FinishPlan([], rows, None))
    else:
        ph, pl = pf.pack_gstream_df64(_small(np.float64))
        rows = FinalRows.from_chunk_row(ph.chunk_row, ph.nr_rows, "cpu")
        device = pf.DF64GStreamDevice.from_packed(
            ph, pl, "cpu", fl.FinishPlan([], rows, None))
    with pytest.raises(TypeError):
        ser.save_device(str(tmp_path / "d.npz"), device)


def test_f64_device_takes_no_f_levels():
    """A plan given to the classic f64 device (a checkpoint's, a band's)
    holds its final only: the f64 forward has no F levels."""
    ph, pl = pf.pack_gstream_df64(_small(np.float64))
    with pytest.raises(ValueError, match="F levels"):
        pf.DF64GStreamDevice.from_packed(
            ph, pl, "cpu", fl.FinishPlan([ph], None, None))


def test_load_device_defaults_to_the_card(tmp_path):
    path = str(tmp_path / "d.npz")
    ser.save_device(path, sf.FusedDevice.from_packed(
        _host.pack_fused(_small()), "cpu"))
    if torch.cuda.is_available():
        assert ser.load_device(path).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            ser.load_device(path)


# -- the host half: pack archives cross over ----------------------------------

def _same_pack(a, b, fields):
    for k in fields:
        x, y = getattr(a, k), getattr(b, k)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert (x is None) == (y is None), k
            if x is not None:
                x, y = np.asarray(x), np.asarray(y)
                assert x.dtype == y.dtype and np.array_equal(x, y), k
        else:
            assert x == y, k


GSTREAM_FIELDS = [f.name for f in dataclasses.fields(pgs.GStreamMatrix)]
FUSED_FIELDS = [f.name for f in dataclasses.fields(pfused.FusedMatrix)]


@pytest.mark.parametrize("kind", ["gstream", "gstream_gl", "fused"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_pack_archives_cross_over(kind, writer, tmp_path):
    m = _small()
    if kind == "fused":
        p, fields = _host.pack_fused(m), FUSED_FIELDS
        save = {"port": ser.save_fused, "jax": jser.save_fused}
        load = {"port": ser.load_fused, "jax": jser.load_fused}
    else:
        p = _host.pack_gstream(m, **({"G": 8, "GL": 2}
                                     if kind == "gstream_gl" else {}))
        fields = GSTREAM_FIELDS
        save = {"port": ser.save_gstream, "jax": jser.save_gstream}
        load = {"port": ser.load_gstream, "jax": jser.load_gstream}
    reader = "jax" if writer == "port" else "port"
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    save[writer](a, p)
    save[reader](b, p)
    _same_archive(a, b)
    _same_pack(load[reader](a), p, fields)
    _same_pack(load[writer](b), p, fields)


@pytest.mark.parametrize("kind", ["gstream", "fused"])
def test_old_archives_load_with_the_defaults(kind, tmp_path):
    """Archives older than the ``Q``, ``GL`` and ``ordered`` fields (a
    6-entry meta) and fused archives without the trailing ``SGRP`` load in
    both packages with the defaults (Q 8, GL 0, unordered; SGRP 1)."""
    m = _small()
    path = str(tmp_path / "old.npz")
    if kind == "fused":
        p = _host.pack_fused(m)
        ser.save_fused(path, p)
        with np.load(path) as z:
            arrs = {k: z[k] for k in z.files}
        arrs["fused_meta"] = arrs["fused_meta"][:-1]
        np.savez_compressed(path, **arrs)
        for load in (ser.load_fused, jser.load_fused):
            q = load(path)
            assert q.SGRP == 1 and q.T == p.T
            assert np.array_equal(q.values, p.values)
        return
    p = _host.pack_gstream(m, Q=8, shuffle_lanes=False)
    assert p.ordered
    ser.save_gstream(path, p)
    with np.load(path) as z:
        arrs = {k: z[k] for k in z.files}
    arrs["meta"] = arrs["meta"][:6]
    np.savez_compressed(path, **arrs)
    for load in (ser.load_gstream, jser.load_gstream):
        q = load(path)
        assert (q.Q, q.GL, q.ordered) == (8, 0, False)
        assert np.array_equal(q.chunk_row, p.chunk_row)
