"""Packed-matrix serialization (checkpoint/resume of the repack artifact).

The reference rebuilds hw_matrix on every run and reports repack time as a
first-class cost (main.cpp:67-72); SURVEY.md section 5 calls out the packed
matrix as the checkpoint-able artifact.  Save/load round-trips both packed
formats as .npz archives.

``save_device``/``load_device`` checkpoint the torch devices in the JAX
package's archive layout (the same keys, dtypes and shapes), so each package
loads the other's archive.  The archive holds the host arrays the device
was uploaded from: the packs, the F-level packs and the host final level;
``load_device`` uploads them through the same constructors as a pack does
and builds again only what the card needs (the fused launch plan, the
final's ``FinalRows`` map, the f64 device's ``LiveSlots``), never the pack
or the finish.  Two forms are the port's own:

  * a classic device whose final is a ``_FinalLevelMulti`` (column-wide
    matrices past 8 column blocks) saves one ``fin{j}_*`` group a flat
    level beside ``fin_levels``, the level count; the JAX package cannot
    save such a device (its ``save_device`` reads ``step_meta`` off the
    multi level) nor read this archive;
  * a bf16 device is refused: the JAX archive of one holds the values as
    raw 2-byte voids, which its own ``load_device`` cannot read.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils.device import CUDA
from .gather_stream import GStreamMatrix


def _meta_vec(p) -> np.ndarray:
    # v3 meta vec: + ordered flag (r2 VERDICT weak #6 — dropping it made
    # reloaded packs rebuild the slower legacy finish)
    return np.array([p.nr_rows, p.nr_cols, p.nr_nzeros, p.G,
                     p.tiles_per_step, p.padded_cols, p.Q, p.GL,
                     1 if p.ordered else 0],
                    dtype=np.int64)


def _meta_q(meta) -> int:
    # archives written before the Q (VF quantum) field carry 6 entries
    return int(meta[6]) if meta.shape[0] > 6 else 8


def _meta_gl(meta) -> int:
    return int(meta[7]) if meta.shape[0] > 7 else 0


def _meta_ordered(meta) -> bool:
    # pre-v3 archives did not persist `ordered`; False is the safe value
    # (the device then rebuilds the legacy finish, which is always valid)
    return bool(meta[8]) if meta.shape[0] > 8 else False


def save_gstream(path: str, p: GStreamMatrix) -> None:
    arrs = dict(values=p.values, cell_idx=p.cell_idx, route=p.route,
                chunk_row=p.chunk_row, step_window=p.step_window,
                meta=_meta_vec(p))
    if p.GL:
        arrs["tile_base"] = p.tile_base
    if p.sections is not None:
        arrs["sections"] = np.asarray(p.sections, dtype=np.int64)
    np.savez_compressed(path, **arrs)


def load_gstream(path: str) -> GStreamMatrix:
    with np.load(path) as z:
        meta = z["meta"]
        return GStreamMatrix(
            values=z["values"], cell_idx=z["cell_idx"], route=z["route"],
            chunk_row=z["chunk_row"], step_window=z["step_window"],
            nr_rows=int(meta[0]), nr_cols=int(meta[1]),
            nr_nzeros=int(meta[2]), G=int(meta[3]),
            tiles_per_step=int(meta[4]), padded_cols=int(meta[5]),
            Q=_meta_q(meta), GL=_meta_gl(meta),
            tile_base=z["tile_base"] if "tile_base" in z else None,
            sections=z["sections"] if "sections" in z else None,
            ordered=_meta_ordered(meta))


# SGRP last: load_fused zips names with the stored vector, so files
# written before a trailing scalar existed load with its default
_FUSED_SCALARS = ("nr_rows", "nr_cols", "nr_nzeros", "Q", "GLW", "T",
                  "GX", "OBp", "F1_max", "F2_max", "F1S", "n_slabs",
                  "fin_direct", "SGRP")
_FUSED_ARRAYS = ("values", "meta_i1", "meta_rt", "tile_base",
                 "fin1_i1", "fin1_rt", "fin2_i1", "fin2_rt",
                 "fin2_group", "fin1_cnt", "fin2_cnt",
                 "step_slab", "step_first", "slab_bounds", "spill_row",
                 "spill_col", "spill_val")


def _fused_arrays(p) -> dict:
    arrs = {k: getattr(p, k) for k in _FUSED_ARRAYS}
    arrs["fused_meta"] = np.array([getattr(p, k) for k in _FUSED_SCALARS],
                                  dtype=np.int64)
    return arrs


def save_fused(path: str, p) -> None:
    """Checkpoint a FusedMatrix (the fused resident-x repack artifact)."""
    np.savez_compressed(path, **_fused_arrays(p))


def _fused_from(z):
    from .fused import FusedMatrix
    scalars = {k: int(v) for k, v in zip(_FUSED_SCALARS, z["fused_meta"])}
    return FusedMatrix(**{k: z[k] for k in _FUSED_ARRAYS}, **scalars)


def load_fused(path: str):
    with np.load(path) as z:
        return _fused_from(z)


# -- the devices --------------------------------------------------------------

def _narrowed(a) -> np.ndarray:
    """``a`` as the JAX package's device copy of it holds it, which is what
    its archive writes for an uploaded array: JAX runs without 64-bit types,
    so int64 and float64 arrays are narrowed to 32 bits."""
    a = np.asarray(a)
    if a.dtype == np.int64:
        return a.astype(np.int32)
    if a.dtype == np.float64:
        return a.astype(np.float32)
    return a


def _lo_plane(plane, hi) -> np.ndarray:
    """The lo f32 plane of a float64 value plane on the card, hi + lo joined
    at upload, beside its hi plane (the host pack's values): hi + lo is
    exact in float64, so plane - hi is lo exactly."""
    return (plane.cpu().numpy() - np.asarray(hi, np.float64)).astype(
        np.float32)


def _level_arrays(fin, prefix: str) -> dict:
    """A host final level's arrays under ``prefix`` (``fin_``, or
    ``fin{j}_`` for a multi final's level j): ``_FinalLevelV2`` with
    ``static_v2``, ``_FinalLevel`` with ``static``; spills only where the
    level has some, as the JAX level keeps them (None when empty)."""
    from .final_levels import _FinalLevelV2
    arrs = {f"{prefix}step_meta": _narrowed(fin.step_meta),
            f"{prefix}cell": _narrowed(fin.cell_idx),
            f"{prefix}route": _narrowed(fin.route)}
    if isinstance(fin, _FinalLevelV2):
        arrs[f"{prefix}tile_bases"] = _narrowed(fin.tile_bases)
        arrs[f"{prefix}static_v2"] = np.array(
            [fin.n_steps, fin.tiles_per_step, fin.GL_f, fin.nwin, fin.GS,
             fin.nt_pad, fin.x_pad_rows, fin.n_spills], dtype=np.int64)
    else:
        arrs[f"{prefix}static"] = np.array(
            [fin.n_steps, fin.tiles_per_step, fin.G, fin.nw, fin.nt_pad,
             fin.x_pad_rows, fin.n_spills], dtype=np.int64)
    if fin.spill_pos.size:
        arrs[f"{prefix}spill_pos"] = _narrowed(fin.spill_pos)
        arrs[f"{prefix}spill_row"] = _narrowed(fin.spill_row)
    return arrs


def _final_arrays(plan) -> dict:
    """The finish's final: one level, the levels of a multi final, or the
    segment-sum route's chunk rows.  Raises TypeError for a final that is
    not a host level (a rank's band's ``FinalRows``)."""
    from .final_levels import _FinalLevel, _FinalLevelMulti, _FinalLevelV2
    fin = plan.final
    if fin is None:
        return {"fallback_chunk_row": _narrowed(plan.chunk_row)}
    if isinstance(fin, (_FinalLevel, _FinalLevelV2)):
        return _level_arrays(fin, "fin_")
    if isinstance(fin, _FinalLevelMulti):
        arrs = {"fin_levels": np.array([len(fin.levels)])}
        for j, lvl in enumerate(fin.levels):
            arrs.update(_level_arrays(lvl, f"fin{j}_"))
        return arrs
    raise TypeError(f"save_device saves a host final level, got "
                    f"{type(fin).__name__}")


def save_device(path: str, device) -> None:
    """Checkpoint a GStreamDevice, FusedDevice, DF64FusedDevice or
    DF64GStreamDevice including its finish, so a resume pays neither the
    repack nor the reduction build.  The archive is the JAX package's (a
    multi final in the port's own keys); the arrays come from the host
    objects the device keeps, but for the f64 devices' lo value planes,
    taken from the card's float64 plane."""
    import torch
    from ..kernels.f64emu import DF64GStreamDevice
    from ..kernels.spmv_fused import DF64FusedDevice, FusedDevice
    from ..kernels.spmv_gstream import GStreamDevice, combine_meta
    if isinstance(device, DF64FusedDevice):
        # one shared metadata set + the lo value plane (+ lo spills)
        arrs = _fused_arrays(device.meta)
        arrs["df64_vlo"] = _lo_plane(device.values, device.meta.values)
        if device.n_spills:
            arrs["df64_spill_vlo"] = _lo_plane(device.spill_val,
                                               device.meta.spill_val)
        return np.savez_compressed(path, **arrs)
    if isinstance(device, FusedDevice):
        return save_fused(path, device.meta)
    if not isinstance(device, GStreamDevice):
        raise TypeError(
            f"save_device supports GStreamDevice / FusedDevice / "
            f"DF64FusedDevice / DF64GStreamDevice, got "
            f"{type(device).__name__}")
    p = device.meta
    df64 = isinstance(device, DF64GStreamDevice)
    if not df64 and device.dtype != torch.float32:
        raise ValueError(
            f"save_device saves f32 values, got {device.dtype}: the JAX "
            f"archive of a bf16 device holds raw 2-byte voids that no "
            f"load_device reads")
    arrs = {"df64": np.array([1]),
            "vhi": _narrowed(p.values),
            "vlo": _lo_plane(device.stream.values, p.values)} if df64 \
        else {"values": _narrowed(p.values)}
    arrs.update({
        "meta16": combine_meta(p.cell_idx, p.route),
        "step_window": _narrowed(p.step_window),
        "chunk_row": p.chunk_row,
        "meta": _meta_vec(p),
    })
    if not df64:
        plan = device.plan
        arrs["n_flevels"] = np.array([len(plan.flevels)])
        if p.GL:
            arrs["tile_base"] = p.tile_base
        if p.sections is not None:
            arrs["sections"] = np.asarray(p.sections, dtype=np.int64)
        for i, fp in enumerate(plan.flevels):
            arrs[f"f{i}_values"] = fp.values
            arrs[f"f{i}_cell"] = fp.cell_idx
            arrs[f"f{i}_route"] = fp.route
            arrs[f"f{i}_chunk_row"] = fp.chunk_row
            arrs[f"f{i}_step_window"] = fp.step_window
            arrs[f"f{i}_meta"] = _meta_vec(fp)
    arrs.update(_final_arrays(device.plan))
    if df64:
        # the JAX f64 archive keeps no segment-sum chunk rows: its load
        # takes them from the pack's chunk_row
        arrs.pop("fallback_chunk_row", None)
    np.savez_compressed(path, **arrs)


def _level_from(z, prefix: str):
    """The host final level saved under ``prefix``."""
    from .final_levels import _FinalLevel, _FinalLevelV2
    empty = np.zeros(0, np.int32)
    sp = z.get(f"{prefix}spill_pos", empty)
    sr = z.get(f"{prefix}spill_row", empty)
    if f"{prefix}static_v2" in z:
        s = z[f"{prefix}static_v2"]
        return _FinalLevelV2(
            z[f"{prefix}step_meta"], z[f"{prefix}tile_bases"],
            z[f"{prefix}cell"], z[f"{prefix}route"], int(s[0]), int(s[1]),
            int(s[2]), int(s[3]), int(s[4]), int(s[5]), int(s[6]), sp, sr)
    s = z[f"{prefix}static"]
    return _FinalLevel(z[f"{prefix}step_meta"], z[f"{prefix}cell"],
                       z[f"{prefix}route"], int(s[0]), int(s[1]), int(s[2]),
                       int(s[3]), int(s[4]), int(s[5]), sp, sr)


def _gstream_from(z, prefix: str = "") -> GStreamMatrix:
    """The pack saved under ``prefix``: the main stream (its meta16 split
    back into cell and route, the exact inverse; f64: its hi plane) or an
    F level's ``f{i}_`` (GL, sections and ``ordered`` dropped, as the JAX
    load drops them)."""
    mm = z[f"{prefix}meta"]
    if prefix:
        cell, route = z[f"{prefix}cell"], z[f"{prefix}route"]
    else:
        m16 = z["meta16"].astype(np.int32) & 0x7FFF
        cell = (m16 >> 7).astype(np.int16)
        route = (m16 & 0x7F).astype(np.int8)
    main = not prefix and "df64" not in z
    return GStreamMatrix(
        values=z["vhi"] if "df64" in z else z[f"{prefix}values"],
        cell_idx=cell, route=route, chunk_row=z[f"{prefix}chunk_row"],
        step_window=z[f"{prefix}step_window"],
        nr_rows=int(mm[0]), nr_cols=int(mm[1]), nr_nzeros=int(mm[2]),
        G=int(mm[3]), tiles_per_step=int(mm[4]), padded_cols=int(mm[5]),
        Q=_meta_q(mm), GL=_meta_gl(mm) if main else 0,
        tile_base=z.get("tile_base") if main else None,
        sections=z.get("sections") if main else None,
        ordered=_meta_ordered(mm) if main else False)


def load_device(path: str, interpret: bool = False, *, device=CUDA):
    """Restore a device checkpoint written by either package's
    ``save_device`` onto ``device`` (the card by default; raises where
    there is none; ``interpret=True`` is the CPU,
    ``utils/device.py:pick_device``): the uploads a pack makes, without
    the pack or the finish build."""
    from ..kernels.f64emu import DF64GStreamDevice
    from ..kernels.spmv_fused import DF64FusedDevice, FusedDevice
    from ..kernels.spmv_gstream import GStreamDevice
    from ..utils.device import pick_device
    from .final_levels import FinishPlan, _FinalLevelMulti
    dev = pick_device(device, interpret)
    with np.load(path) as f:
        z = {k: f[k] for k in f.files}
    if "fused_meta" in z:
        ph = _fused_from(z)
        if "df64_vlo" not in z:
            return FusedDevice.from_packed(ph, dev)
        pl = dataclasses.replace(
            ph, values=z["df64_vlo"],
            spill_val=z.get("df64_spill_vlo", ph.spill_val))
        return DF64FusedDevice.from_packed(ph, pl, dev)
    values = z["vhi"] if "df64" in z else z["values"]
    if values.dtype != np.float32:
        raise ValueError(f"{path}: values of type {values.dtype} (a bf16 "
                         f"device's archive holds raw 2-byte voids); "
                         f"load_device reads f32 value planes")
    packed = _gstream_from(z)
    if "df64" in z:
        final = _level_from(z, "fin_") if "fin_static" in z else None
        plan = FinishPlan([], final, None if final is not None else
                          packed.chunk_row.reshape(-1).astype(np.int32))
        packed_lo = dataclasses.replace(packed, values=z["vlo"])
        return DF64GStreamDevice.from_packed(packed, packed_lo, dev, plan)
    flevels = [_gstream_from(z, f"f{i}_")
               for i in range(int(z["n_flevels"][0]))]
    if "fin_levels" in z:
        final = _FinalLevelMulti([_level_from(z, f"fin{j}_")
                                  for j in range(int(z["fin_levels"][0]))])
    elif "fin_static_v2" in z or "fin_static" in z:
        final = _level_from(z, "fin_")
    else:
        final = None
    plan = FinishPlan(flevels, final,
                      z["fallback_chunk_row"] if final is None else None)
    return GStreamDevice(packed, device=dev, plan=plan)
