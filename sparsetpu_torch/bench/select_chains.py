"""The TPU's select-chain experiments on the card: the design experiments
``scripts/exp_q.py`` (#22, the forward's rate against (G, P)) and
``scripts/exp_r3.py`` (#23, cheaper G = 16 select chains), their kernels
in ``csrc/select_chains.cu``.

Every script kernel is one form of ``select_forward`` on the script's own
inputs (``gather_rate_inputs``, ``tilebase_variant_inputs``,
``select16_inputs``, ``tb_tree_inputs``, ``tb_tree_i8_inputs``: the
scripts' numpy draws, in their order).  Phases of ``bench_select_chains``,
each timed back to back (``stream_ms``) and a call at a time
(``call_ms``, ``bench/harness.py``):

  q:chain@G,P      exp_q.py:55-82: the G-group chain on c % 8G, P output
                   planes, G in 1..32, P in 1, 2, 4 (the default grid,
                   :51-52); fused int16 meta of any 15 bits
  q:bigdual@G      :89-98: one load at row c % 8G (``direct``), G 4, 8, 32
  q:tilebase@32    :109-120: one load at 8 base + (c % 8), a base a tile in
                   [0, 32) (``direct``)
  q:tb@GL,P        :164-193: the GL-group chain at a base a tile, cells in
                   [0, 8 GL), P planes, (GL, P) as :145-146
  r3:chain16       exp_r3.py:77-89: the 16-group chain (0 past 16 groups)
  r3:tree16        :96-112: 16 loads merged in 4 levels (wraps past 16)
  r3:hilo16        :119-157: x as int16 hi and lo planes, 8 pairs
  r3:direct16      not a script kernel: chain16's function by one load,
                   the card's own answer to the chain
  r3:tb_res        :182-192: one load at 8 base + (c & 7), x of 1024 rows
  r3:tb_res2       :221-236: two bases a tile, the range bit (c >> 3) != 0
  r3:tb_tree16     :320-336: tree16 at a base a tile
  r3:tb2_tree8     :341-365: two bases, an 8-group tree each, range bit
                   c >> 6
  r3:tb_tree16_i8  :403-418: tb_tree16 on split int8 meta (cells, routes)

Each phase runs at its script's tile count (exp_q 8192, exp_r3 4096: 64
and 32 blocks of 128 tiles) and, suffixed ``:32768``, at 32768 tiles with
the same recipe; chain16, tree16, hilo16 and direct16 also at 32768
tiles, 16 a block (``:32768:T16``).  At the scripts' counts the streams
are 27-67 MB, in or at the edge of the card's 50 MB L2, so those phases
carry no HBM bound; at 32768 tiles they are 218-268 MB.  The bound
counts 4 B of value a slot, 2 B of meta, 4 B a base, 4 B an output
element and the window once.

``select_forward`` launches the CUDA kernel for CUDA tensors (or raises)
and runs ``select_forward_reference`` for CPU tensors; it counts its
launches by kernel (``chain``, ``tree``, ``direct``, ``hilo``, and
``tree_i8`` on split meta).  The scripts' ``hilo16`` folds ``xw[0, 0] *
1e-30`` into each step's first row against its chained timer
(exp_r3.py:157); CUDA events need no such guard, so the port leaves it
out.

    python -m sparsetpu_torch.bench.select_chains [--only NAME ...]
        [--device cuda|cpu] [--small]

``--only`` takes phase names with or without their size, families
(``q:chain``, ``q:tb``, ``r3:tb_res``, ...) and the scripts (``q``, ``r3``).
"""

from __future__ import annotations

import collections
import ctypes
import json
import sys

import numpy as np
import torch

from ..kernels._build import check as check_rc, library
from ..utils.config import LANES, SUBLANES as CHUNK
from ..utils.device import hbm_gbps, require_device
from .harness import call_ms, stream_ms

FORMS = {"chain": 0, "tree": 1, "direct": 2, "hilo": 3}
SCRIPT_T = 128                     # tiles a grid step, both scripts
BIG_TILES = 32768                  # past the L2, the same recipe

# -- #22, exp_q.py ------------------------------------------------------------
Q_TILES = 8192                                           # exp_q.py:38
Q_X_ROWS = CHUNK * 32                                    # :24, :42
Q_COMBOS = tuple((g, p) for g in (1, 2, 4, 8, 16, 32)   # :51-52
                 for p in (1, 2, 4))
Q_BIGDUAL = (4, 8, 32)                                   # :86
TB_COMBOS = ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (2, 4))   # :145-146

# -- #23, exp_r3.py -----------------------------------------------------------
R3_TILES = 4096                                          # exp_r3.py:54
R3_G = 16                                                # :34
R3_X_ROWS = CHUNK * 128                                  # GR, :185
R3_MAIN = ("chain16", "tree16", "hilo16", "tb_res", "tb_res2")   # main
# variant -> select_forward's settings (the meta, x and bases are the
# variant's inputs)
R3_SETTINGS = {
    "chain16": dict(form="chain", G=16),
    "tree16": dict(form="tree", G=16),
    "hilo16": dict(form="hilo", G=16),
    "direct16": dict(form="direct", G=16),
    "tb_res": dict(form="direct", G=1, mod=True),
    "tb_res2": dict(form="direct", G=1),
    "tb_tree16": dict(form="tree", G=16),
    "tb2_tree8": dict(form="tree", G=8),
    "tb_tree16_i8": dict(form="tree", G=16),
}
R3_PHASES = ("chain16", "tree16", "hilo16", "direct16", "tb_res", "tb_res2",
             "tb_tree16", "tb2_tree8", "tb_tree16_i8")
# the G = 16 forms again at the large size, 16 tiles a block: 2048 blocks
# where the scripts' 128 make 256 on 132 SMs
FINE_T = 16
FINE_PHASES = ("chain16", "tree16", "hilo16", "direct16")


def _up(a, dtype, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# -- the wrapper and its plain version ----------------------------------------

def _need(name, t, dtype, dev, shape=None) -> None:
    if t is None or not torch.is_tensor(t) or t.dtype != dtype or \
            t.device != dev or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {dtype} tensor on "
                         f"{dev}")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{shape}")


def _check(form, xw, values, meta, G, P, base, T) -> tuple:
    """Dtype, device, contiguity and shape checks of the kernel and its
    plain version; returns (tiles, bases a tile, split meta)."""
    if form not in FORMS:
        raise ValueError(f"unknown form {form!r} (one of {list(FORMS)})")
    if G not in (1, 2, 4, 8, 16, 32) or (form == "hilo" and G < 2):
        raise ValueError(f"G={G}: a power of two in [1, 32] (hilo: >= 2)")
    if P not in (1, 2, 4, 8) or T < 1:
        raise ValueError(f"P={P} must divide 8 and T={T} be positive")
    dev = values.device
    _need("values", values, torch.float32, dev)
    if values.dim() != 2 or values.shape[1] != LANES or \
            values.shape[0] % CHUNK:
        raise ValueError("values must be (n_tiles*8, 128)")
    n = values.shape[0] // CHUNK
    split = isinstance(meta, (tuple, list))
    if split:
        if len(meta) != 2:
            raise ValueError("split meta is (cells, routes), two int8 "
                             "tensors")
        for name, t in zip(("cells", "routes"), meta):
            _need(name, t, torch.int8, dev, tuple(values.shape))
    else:
        _need("meta", meta, torch.int16, dev, tuple(values.shape))
    if form == "hilo":
        _need("xw", xw, torch.int16, dev, (2 * CHUNK * G, LANES))
    else:
        _need("xw", xw, torch.float32, dev)
        if xw.dim() != 2 or xw.shape[1] != LANES or xw.shape[0] % CHUNK or \
                xw.shape[0] < CHUNK * G:
            raise ValueError(f"xw must be (8*groups, 128) with groups >= "
                             f"G={G}; it is {tuple(xw.shape)}")
    n_bases = 0
    if base is not None:
        _need("base", base, torch.int32, dev)
        if form == "hilo" or base.numel() not in (n, 2 * n) or n == 0:
            raise ValueError(f"base has {base.numel()} entries: one or two "
                             f"a tile of {n} (and none for hilo)")
        n_bases = base.numel() // n
    return n, n_bases, split


def _decode(values, meta, split, n) -> tuple:
    """(j, c) of every slot, (n, 8, 128) int64: the route at the slot's
    lane and the cell at the routed lane, as the kernel reads them."""
    if split:
        cells, routes = (t.view(n, CHUNK, LANES).long() for t in meta)
        j = routes & 127
        return j, torch.gather(cells, 2, j) & 0xFF
    m = meta.view(n, CHUNK, LANES).long() & 0x7FFF
    j = m & 127
    return j, torch.gather(m, 2, j) >> 7


def select_index(form, xw, values, meta, *, G: int, P: int = 1, base=None,
                 mod: bool = False, T: int = SCRIPT_T) -> tuple:
    """(idx, ok), each (n_tiles, 8, 128): the flat index into the f32 x
    (for hilo the x its planes rebuild) that slot (t, s, l) reads at lane
    j, and whether it reads one (else its x is 0): with c % 8G where
    ``mod``; with two bases the window ``(c >> (3 + log2 G)) != 0`` and c's
    bits below it; the row 8b + (c % 8G) for tree, 8b + c where c >> 3 < G
    for the others; b the tile's base clamped into [0, x_rows/8 - G]."""
    n, n_bases, split = _check(form, xw, values, meta, G, P, base, T)
    j, c = _decode(values, meta, split, n)
    span = CHUNK * G
    if mod:
        c = c % span
    b = torch.zeros(n, 1, 1, dtype=torch.long, device=values.device)
    if n_bases:
        top = xw.shape[0] // CHUNK - G
        bb = base.view(n, n_bases).long().clamp(0, top)
        b = bb[:, :1].view(n, 1, 1)
        if n_bases == 2:
            far = (c >> (3 + G.bit_length() - 1)) != 0
            b = torch.where(far, bb[:, 1].view(n, 1, 1), b)
            c = c % span
    if form == "tree":
        ok = torch.ones_like(c, dtype=torch.bool)
        row = CHUNK * b + c % span
    else:
        ok = (c >> 3) < G
        row = CHUNK * b + c
    return torch.where(ok, row * LANES + j, 0), ok


def hilo_planes(xw: torch.Tensor) -> torch.Tensor:
    """exp_r3.py:146-150's int16 planes of an f32 x: the high 16 bits of
    every row, then the low 16, ``(2 * rows, 128)`` int16."""
    w = xw.contiguous().view(torch.int32)
    return torch.cat([(w >> 16).to(torch.int16),
                      (w & 0xFFFF).to(torch.int16)]).contiguous()


def hilo_x(planes: torch.Tensor) -> torch.Tensor:
    """The f32 x that ``hilo_planes`` split: ``(hi << 16) | (lo & 0xFFFF)``
    row by row, bit for bit."""
    hi, lo = planes.view(2, -1, LANES).to(torch.int32)
    return ((hi << 16) | (lo & 0xFFFF)).contiguous().view(torch.float32)


def select_forward_reference(form, xw, values, meta, *, G: int, P: int = 1,
                             base=None, mod: bool = False,
                             T: int = SCRIPT_T) -> torch.Tensor:
    """Plain PyTorch version of every form: (n_tiles*P, 128) f32, plane p
    of tile t the sum over its sublanes [pQ, (p+1)Q), Q = 8 / P, of values
    times x at ``select_index``, gathered at once (no chain).  Like the
    kernel, it reads nothing out of bounds on any input of the right
    shapes."""
    idx, ok = select_index(form, xw, values, meta, G=G, P=P, base=base,
                           mod=mod, T=T)
    x = hilo_x(xw) if form == "hilo" else xw
    xv = torch.where(ok, x.reshape(-1)[idx], 0.0)
    n = idx.shape[0]
    prod = values.view(n, CHUNK, LANES) * xv
    return prod.view(n, P, CHUNK // P, LANES).sum(2).reshape(n * P, LANES)


def check_values(form, xw, values, meta, *, G: int, P: int = 1, base=None,
                 mod: bool = False, T: int = SCRIPT_T) -> None:
    """Raise on a value for which the script's kernel has no defined
    result (one device sync): a negative int8 cell or route; a negative
    base (the window's dynamic slice clamps a start past the end, but
    Pallas interpret mode wraps a negative one as numpy indexes, where the
    kernel clamps it to 0); a cell past the one 8-row group of a take with
    no select (exp_q.py:171-172, GL = 1)."""
    n, n_bases, split = _check(form, xw, values, meta, G, P, base, T)
    if n_bases and int(base.min()) < 0:
        raise ValueError("base: a negative window base (the scripts draw "
                         "bases >= 0)")
    if split:
        for name, t in zip(("cells", "routes"), meta):
            if t.numel() and int(t.min()) < 0:
                raise ValueError(f"{name}: a negative int8 byte (the script "
                                 f"reads int8 cells and routes in [0, 128))")
    if form in ("chain", "direct") and G == 1 and not mod and n_bases < 2:
        _, c = _decode(values, meta, split, n)
        if c.numel() and int(c.max()) >= CHUNK:
            raise ValueError("a cell past the 8-row window of a take with no "
                             "select (G = 1): the script's take_along_axis "
                             "has no window to select from")


def select_forward(form, xw, values, meta, *, G: int, P: int = 1, base=None,
                   mod: bool = False, T: int = SCRIPT_T,
                   check: bool = True) -> torch.Tensor:
    """One script kernel of #22 or #23 in ``form`` (chain, tree, direct,
    hilo; ``csrc/select_chains.cu``): (n_tiles*P, 128) f32.  ``meta`` is
    the fused int16 stream or (cells, routes), two int8 streams; ``base``
    None, one or two int32 bases a tile; ``mod`` takes c % 8G first;
    ``xw`` the f32 x, for hilo its int16 planes (``hilo_planes``).
    ``check`` runs ``check_values`` first (a device sync); without it the
    kernel still reads nothing out of bounds (``select_index``).

    On CUDA tensors it launches the kernel on the current stream, T tiles
    a block (or raises); on CPU tensors it runs
    ``select_forward_reference``.  ``select_forward.launches`` counts the
    launches by kernel: the form, ``_i8`` on split meta."""
    if check:
        check_values(form, xw, values, meta, G=G, P=P, base=base, mod=mod,
                     T=T)
    if values.device.type == "cpu":
        return select_forward_reference(form, xw, values, meta, G=G, P=P,
                                        base=base, mod=mod, T=T)
    if values.device.type != "cuda":
        raise ValueError(f"select_forward: unsupported device "
                         f"{values.device}")
    n, n_bases, split = _check(form, xw, values, meta, G, P, base, T)
    cells, routes = meta if split else (None, None)

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr() if t is not None else 0)
    lib = library().lib
    with torch.cuda.device(values.device):
        out = torch.empty(n * P, LANES, device=values.device)
        stream = torch.cuda.current_stream(values.device).cuda_stream
        rc = lib.select_chains_launch(
            FORMS[form], int(split), ptr(values),
            ptr(None if split else meta), ptr(cells), ptr(routes), ptr(base),
            ptr(xw), ptr(out), n, T, G.bit_length() - 1, P, n_bases,
            int(mod), xw.shape[0], ctypes.c_void_p(stream))
    check_rc(lib, rc, f"select_forward ({form}) launch")
    select_forward.launches[form + ("_i8" if split else "")] += 1
    return out


select_forward.launches = collections.Counter()


# -- the inputs: the scripts' draws -------------------------------------------

def gather_rate_inputs(n_tiles: int = Q_TILES, T: int = SCRIPT_T,
                       device="cuda") -> dict:
    """exp_q.py:main's inputs (:38-44, 122-123), from ``default_rng(0)`` in
    the script's order: values (n_tiles*8, 128) f32, int16 meta of any 15
    bits (cells in [0, 256)), xw (256, 128) f32, then a base a tile in
    [0, 32), (n_tiles/T, T) int32 (drawn whatever runs)."""
    dev = require_device(device)
    rng = np.random.default_rng(0)
    rows = n_tiles * CHUNK
    values = rng.standard_normal((rows, LANES)).astype(np.float32)
    meta = rng.integers(0, 1 << 15, size=(rows, LANES)).astype(np.int16)
    xw = rng.standard_normal((Q_X_ROWS, LANES)).astype(np.float32)
    base = rng.integers(0, 32, size=(n_tiles // T, T))
    return dict(values=_up(values, np.float32, dev),
                meta=_up(meta, np.int16, dev), xw=_up(xw, np.float32, dev),
                base=_up(base, np.int32, dev))


def tilebase_variant_inputs(n_tiles: int = Q_TILES, T: int = SCRIPT_T,
                            combos=TB_COMBOS, device="cuda") -> dict:
    """exp_q.py:tilebase_variants' inputs (:149-162), from
    ``default_rng(0)`` in the script's order: values, xw (256, 128), then
    for each (GL, P) of ``combos`` the int16 meta (cells in [0, 8 GL) << 7
    | routes) and a base a tile in [0, 33 - GL).  Returns {values, xw,
    variants: {(GL, P): {meta, base}}}."""
    dev = require_device(device)
    rng = np.random.default_rng(0)
    rows = n_tiles * CHUNK
    values = rng.standard_normal((rows, LANES)).astype(np.float32)
    xw = rng.standard_normal((Q_X_ROWS, LANES)).astype(np.float32)
    variants = {}
    for GL, P in combos:
        cells = rng.integers(0, CHUNK * GL, size=(rows, LANES))
        route = rng.integers(0, LANES, size=(rows, LANES))
        meta = ((cells << 7) | route).astype(np.int16)
        base = rng.integers(0, 32 - GL + 1, size=(n_tiles // T, T))
        variants[(GL, P)] = dict(meta=_up(meta, np.int16, dev),
                                 base=_up(base, np.int32, dev))
    return dict(values=_up(values, np.float32, dev),
                xw=_up(xw, np.float32, dev), variants=variants)


def _r3_steps(n_tiles: int) -> int:
    if n_tiles < SCRIPT_T or n_tiles % SCRIPT_T:
        raise ValueError(f"n_tiles={n_tiles}: exp_r3.py's grid steps are "
                         f"{SCRIPT_T} tiles")
    return n_tiles // SCRIPT_T


def select16_inputs(n_tiles: int = R3_TILES, only=None,
                    device="cuda") -> dict:
    """exp_r3.py:main's inputs (:57-65, 146-150, 195-198, 239-242), from
    ``default_rng(0)`` in the script's order: values, int16 meta (cells
    in [0, 128) << 7 | routes), xw (128, 128) f32 and its ``hilo_planes``;
    then for tb_res and tb_res2, each only where it runs (``only``, the
    script's argv variants; None runs all), {base, xw}: bases in [0, 128),
    one a tile (n_steps, 128) or two (n_steps, 256), and an x of 1024
    rows."""
    dev = require_device(device)
    n_steps = _r3_steps(n_tiles)
    rng = np.random.default_rng(0)
    rows = n_tiles * CHUNK
    values = rng.standard_normal((rows, LANES)).astype(np.float32)
    route = rng.integers(0, LANES, size=(rows, LANES))
    cells = rng.integers(0, CHUNK * R3_G, size=(rows, LANES))
    meta = ((cells << 7) | route).astype(np.int16)
    xw = _up(rng.standard_normal((CHUNK * R3_G, LANES)), np.float32, dev)
    out = dict(values=_up(values, np.float32, dev),
               meta=_up(meta, np.int16, dev), xw=xw, xw_hilo=hilo_planes(xw))
    for name, width in (("tb_res", 1), ("tb_res2", 2)):
        if only and name not in only:
            continue
        base = rng.integers(0, R3_X_ROWS // CHUNK,
                            size=(n_steps, width * SCRIPT_T))
        xbig = rng.standard_normal((R3_X_ROWS, LANES))
        out[name] = dict(base=_up(base, np.int32, dev),
                         xw=_up(xbig, np.float32, dev))
    return out


def tb_tree_inputs(n_tiles: int = R3_TILES, device="cuda") -> dict:
    """exp_r3.py:extra_variants' inputs (:264-279, 295-296, 317-318), from
    ``default_rng(0)`` in the script's order: values, routes, xw (1024,
    128), int16 meta (cells in [0, 128) << 7 | routes), then tb_tree16's
    bases, one a tile, and tb2_tree8's, two, in [0, 112)."""
    dev = require_device(device)
    n_steps = _r3_steps(n_tiles)
    rng = np.random.default_rng(0)
    rows = n_tiles * CHUNK
    values = rng.standard_normal((rows, LANES)).astype(np.float32)
    route = rng.integers(0, LANES, size=(rows, LANES))
    xw = rng.standard_normal((R3_X_ROWS, LANES))
    cells = rng.integers(0, CHUNK * 16, size=(rows, LANES))
    meta = ((cells << 7) | route).astype(np.int16)
    out = dict(values=_up(values, np.float32, dev),
               xw=_up(xw, np.float32, dev), meta=_up(meta, np.int16, dev))
    for name, width in (("tb_tree16", 1), ("tb2_tree8", 2)):
        base = rng.integers(0, R3_X_ROWS // CHUNK - 16,
                            size=(n_steps, width * SCRIPT_T))
        out[name] = _up(base, np.int32, dev)
    return out


def tb_tree_i8_inputs(n_tiles: int = R3_TILES, device="cuda") -> dict:
    """exp_r3.py:i8_variant's inputs (:378-392), from ``default_rng(0)`` in
    the script's order: values, int8 routes, int8 cells in [0, 128), xw
    (1024, 128), a base a tile in [0, 112)."""
    dev = require_device(device)
    n_steps = _r3_steps(n_tiles)
    rng = np.random.default_rng(0)
    rows = n_tiles * CHUNK
    values = rng.standard_normal((rows, LANES)).astype(np.float32)
    routes = rng.integers(0, LANES, size=(rows, LANES)).astype(np.int8)
    cells = rng.integers(0, CHUNK * 16, size=(rows, LANES)).astype(np.int8)
    xw = rng.standard_normal((R3_X_ROWS, LANES))
    base = rng.integers(0, R3_X_ROWS // CHUNK - 16, size=(n_steps, SCRIPT_T))
    return dict(values=_up(values, np.float32, dev),
                cells=_up(cells, np.int8, dev),
                routes=_up(routes, np.int8, dev),
                xw=_up(xw, np.float32, dev), base=_up(base, np.int32, dev))


# -- the bench ----------------------------------------------------------------

def tile_counts(small: bool = False) -> tuple:
    """(exp_q's tiles, exp_r3's tiles, the large size); ``small`` cuts each
    by 32 for a CPU rehearsal."""
    if small:
        return Q_TILES // 32, R3_TILES // 32, BIG_TILES // 32
    return Q_TILES, R3_TILES, BIG_TILES


def _wanted(name: str, only) -> bool:
    """A phase runs when ``only`` is None or names it, with or without its
    size, or its family (the name up to ``@``) or its script (``q``,
    ``r3``)."""
    if only is None:
        return True
    script, rest = name.split(":", 1)
    bare = f"{script}:{rest.split(':')[0]}"
    return bool({name, bare, bare.split("@")[0], script} & set(only))


def _q_phases(dev, n, T, suffix, want) -> list:
    """(name, select_forward's arguments) of exp_q's wanted phases at n
    tiles."""
    out = []
    names = [f"q:chain@{g},{p}" for g, p in Q_COMBOS] + \
        [f"q:bigdual@{g}" for g in Q_BIGDUAL] + ["q:tilebase@32"]
    if any(want(k + suffix) for k in names):
        a = gather_rate_inputs(n, T, device=dev)
        common = dict(xw=a["xw"], values=a["values"], meta=a["meta"],
                      mod=True)
        for g, p in Q_COMBOS:
            out.append((f"q:chain@{g},{p}",
                        dict(common, form="chain", G=g, P=p)))
        for g in Q_BIGDUAL:
            out.append((f"q:bigdual@{g}", dict(common, form="direct", G=g)))
        out.append(("q:tilebase@32",
                    dict(common, form="direct", G=1, base=a["base"])))
    if any(want(f"q:tb@{g},{p}{suffix}") for g, p in TB_COMBOS):
        a = tilebase_variant_inputs(n, T, device=dev)
        for (g, p), v in a["variants"].items():
            out.append((f"q:tb@{g},{p}", dict(
                form="chain", xw=a["xw"], values=a["values"], meta=v["meta"],
                base=v["base"], G=g, P=p)))
    return [(k + suffix, a) for k, a in out if want(k + suffix)]


def _r3_phases(dev, n, suffix, want) -> list:
    """(name, select_forward's arguments) of exp_r3's wanted phases at n
    tiles; tb_res and tb_res2 draw their inputs only where they run, as
    the script's ``only`` does."""
    out = []
    wanted = [v for v in R3_PHASES if want(f"r3:{v}{suffix}")]
    main = [v for v in wanted if v in R3_MAIN or v == "direct16"]
    if main:
        only = None if all(v in main for v in R3_MAIN) else set(main)
        a = select16_inputs(n, only, device=dev)
        for v in main:
            args = dict(values=a["values"], meta=a["meta"], xw=a["xw"])
            if v == "hilo16":
                args["xw"] = a["xw_hilo"]
            elif v.startswith("tb_res"):
                args.update(a[v])
            out.append((v, dict(args, **R3_SETTINGS[v])))
    if {"tb_tree16", "tb2_tree8"} & set(wanted):
        a = tb_tree_inputs(n, device=dev)
        for v in ("tb_tree16", "tb2_tree8"):
            out.append((v, dict(values=a["values"], meta=a["meta"],
                                xw=a["xw"], base=a[v], **R3_SETTINGS[v])))
    if "tb_tree16_i8" in wanted:
        a = tb_tree_i8_inputs(n, device=dev)
        out.append(("tb_tree16_i8", dict(
            values=a["values"], meta=(a["cells"], a["routes"]), xw=a["xw"],
            base=a["base"], **R3_SETTINGS["tb_tree16_i8"])))
    order = {v: k for k, v in enumerate(R3_PHASES)}
    out.sort(key=lambda e: order[e[0]])
    return [(f"r3:{v}{suffix}", a) for v, a in out if v in wanted]


def phase_args(dev, only=None, small: bool = False) -> list:
    """(name, select_forward's arguments) of every wanted phase: each
    script's at its count, then at the large size, then the G = 16 forms
    at ``FINE_T`` tiles a block; each size's inputs are drawn when it is
    reached."""
    q_n, r3_n, big = tile_counts(small)

    def want(name):
        return _wanted(name, only)
    out = []
    for sq, sr, suffix in ((q_n, r3_n, ""), (big, big, f":{big}")):
        out += _q_phases(dev, sq, SCRIPT_T, suffix, want)
        out += _r3_phases(dev, sr, suffix, want)
    fine = {f"r3:{v}:{big}:T{FINE_T}" for v in FINE_PHASES}
    fine = {k for k in fine if want(k)}
    if fine:
        have = dict(out)
        need = {k.rsplit(":", 1)[0] for k in fine} - set(have)
        if need:
            have.update(_r3_phases(dev, big, f":{big}", need.__contains__))
        out += [(k, dict(have[k.rsplit(":", 1)[0]], T=FINE_T))
                for k in (f"r3:{v}:{big}:T{FINE_T}" for v in FINE_PHASES)
                if k in fine]
    return out


def phase_bytes(args) -> int:
    """The bytes a phase must move: values, meta, bases and the window
    read once, the output written once."""
    meta = args["meta"]
    metas = list(meta) if isinstance(meta, (tuple, list)) else [meta]
    streams = [args["values"], args["xw"], *metas] + (
        [args["base"]] if args.get("base") is not None else [])
    return _nbytes(*streams) + args["values"].shape[0] // CHUNK * \
        args.get("P", 1) * LANES * 4


def bench_select_chains(*, device="cuda", only=None, small: bool = False,
                        timer=None, verbose: bool = False) -> dict:
    """Time every phase of this module's docstring on ``device`` (with
    ``small``, tile counts cut by 32 for a CPU rehearsal).  ``only`` keeps
    the phases it names (``_wanted``).

    Returns {phase: {stream_ms, call_ms, tiles, bytes, bound_ms, launches,
    gslot_s, args}}: ``bound_ms`` is ``bytes`` at the card's HBM rate at
    the large size, None at the scripts' counts (in or at the edge of the
    L2) and on the CPU; ``launches`` counts each kernel's launches during
    the phase; ``gslot_s`` is slots over ``stream_ms``; ``args`` the
    kernel's arguments, to hold it against its plain version.  The value
    checks run once a phase, outside the clocks.  On the CPU the phases
    run the plain versions and ``timer(fn, device) -> ms`` must be given
    (it replaces both clocks): CPU times are not kernel times."""
    dev = require_device(device)
    if timer is None:
        if dev.type != "cuda":
            raise ValueError("bench_select_chains on the CPU needs a timer: "
                             "CPU times are not kernel times")
        stream_t, call_t = stream_ms, call_ms
    else:
        stream_t = call_t = timer
    big = tile_counts(small)[2]
    gbps = hbm_gbps(dev) if dev.type == "cuda" else None
    results = {}
    warm = dev.type == "cuda"
    for name, args in phase_args(dev, only, small):
        check_values(**args)

        def fn(args=args):
            return select_forward(**args, check=False)
        if warm:
            # warm the card, so that the first phase is not timed at idle
            # clocks
            for _ in range(200):
                fn()
            torch.cuda.synchronize(dev)
            warm = False
        n = args["values"].shape[0] // CHUNK
        nbytes = phase_bytes(args)
        before = dict(select_forward.launches)
        r = {"stream_ms": stream_t(fn, dev), "call_ms": call_t(fn, dev),
             "tiles": n, "bytes": nbytes,
             "bound_ms": nbytes / (gbps * 1e9) * 1e3
             if gbps and n == big else None}
        after = dict(select_forward.launches)
        r["launches"] = {k: after[k] - before.get(k, 0) for k in after
                         if after[k] != before.get(k, 0)}
        r["gslot_s"] = n * CHUNK * LANES / (r["stream_ms"] * 1e-3) / 1e9
        r["args"] = args
        results[name] = r
        if verbose:
            print("  " + describe_phase(name, r), flush=True)
    return results


def describe_phase(name: str, r: dict) -> str:
    """One line of a phase's result."""
    line = (f"{name:24s} {r['stream_ms']:8.4f} ms back to back "
            f"{r['call_ms']:8.4f} ms a call  {r['bytes'] / 1e6:7.2f} MB  "
            f"{r['gslot_s']:7.1f} Gslot/s")
    if r["bound_ms"]:
        line += f"  {r['bound_ms'] / r['stream_ms']:.3f} of its bound"
    return line


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m sparsetpu_torch.bench.select_chains",
        description="the TPU's select-chain experiments on the card")
    ap.add_argument("--only", nargs="+", default=None,
                    help="phases, families or scripts (q, r3, q:chain, "
                         "q:chain@16,1, r3:tree16:32768, ...)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--small", action="store_true",
                    help="tile counts cut by 32 for a CPU rehearsal")
    args = ap.parse_args(argv)
    dev = require_device(args.device)
    if dev.type == "cuda":
        from ..utils.device import card_line
        print(card_line(), flush=True)
        timer = None
    else:
        print("CPU run: plain versions, host clock (not kernel times)",
              flush=True)

        def timer(fn, d):
            return call_ms(fn, d, repeats=3)
    res = bench_select_chains(device=dev, only=args.only, small=args.small,
                              timer=timer, verbose=True)
    print(json.dumps({k: {kk: vv for kk, vv in v.items() if kk != "args"}
                      for k, v in res.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
