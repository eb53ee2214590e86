"""Final-level builders of the classic GStream device: the host half of
the chunk -> row reduction (the port's own copy of the NumPy builders in
the JAX package's ``kernels/spmv_pallas.py``).

The chunk partial sums of a classic pack reduce into y on the device, in
one gather-accumulate *final level* whose output cell (r // 128, r % 128)
IS y[r]; rows with many partials are first pre-reduced by 0/1-incidence
*F levels* (ordinary GStream packs run by the forward kernel).  This module
builds those levels on the host, as NumPy arrays, with the same greedy
placements, cost models (fitted on a TPU v5e, kept unchanged) and native
C++ builder as the JAX package, so both packages build byte-identical
finals.  ``kernels/spmv_gstream.py`` uploads and runs them.

  _FinalLevel       legacy final: <= nw dynamically placed windows of 8G
                    rows per output step (shuffled packs, F levels)
  _FinalLevelV2     flat final: per (out tile, window) one GL_f-group base
                    (ordered packs, <= 8 column blocks)
  _FinalLevelMulti  a sum of _FinalLevelV2 over groups of <= 8 blocks
  build_finish      the whole finish plan of one pack
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..formats.csr import CSRMatrix
from .gather_stream import (CHUNK, LANES, STRIPE, GStreamMatrix,
                            _match_tiles, pack_gstream)

HEAVY_CAP = 32       # rows with more partials get an F pre-reduction


def _rank_in_group(keys):
    """Per-element rank within its key group; keys need not be sorted.
    Returns (rank, order) where order sorts by key (stable)."""
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    if ks.shape[0] == 0:
        return np.zeros(0, np.int64), order
    starts = np.concatenate([[0], np.flatnonzero(np.diff(ks)) + 1])
    counts = np.diff(np.concatenate([starts, [ks.shape[0]]]))
    rank_sorted = np.arange(ks.shape[0]) - np.repeat(starts, counts)
    rank = np.empty_like(rank_sorted)
    rank[order] = rank_sorted
    return rank, order


def _assign_passes(rows, pos, step_of, win, nw_max, p_cap, n_steps):
    """Greedy pass/window assignment for the final level.

    Each pass gives every row 8 gather slots (one chunk at its fixed
    (r//128, r%128) cell) and every output step up to ``nw_max``
    dynamically chosen aligned x-windows of ``win`` positions.  Children
    are placed in the earliest pass whose fan-in and window budget admit
    them.  Returns (pass_of [-1 = unassigned], slot_of, W[p, step, nw])."""
    n = rows.shape[0]
    win_of = pos // win
    wmod = int(win_of.max()) + 2 if n else 2
    pass_of = np.full(n, -1, dtype=np.int16)
    slot_of = np.full(n, -1, dtype=np.int8)
    Ws = []
    remaining = np.ones(n, dtype=bool)
    for p in range(p_cap):
        idx = np.flatnonzero(remaining)
        if idx.size == 0:
            break
        rank, _ = _rank_in_group(rows[idx])
        cand = idx[rank < CHUNK]
        if cand.size == 0:
            break
        # top nw_max windows per step by child count
        key = step_of[cand].astype(np.int64) * wmod + win_of[cand]
        uk, inv, cnt = np.unique(key, return_inverse=True,
                                 return_counts=True)
        st = uk // wmod
        order = np.lexsort((-cnt, st))
        wrank, _ = _rank_in_group(st[order])
        slot_of_uk = np.full(uk.size, -1, dtype=np.int8)
        slot_of_uk[order] = np.where(wrank < nw_max, wrank,
                                     -1).astype(np.int8)
        ch_slot = slot_of_uk[inv]
        take = ch_slot >= 0
        tk = cand[take]
        pass_of[tk] = p
        slot_of[tk] = ch_slot[take]
        remaining[tk] = False
        W = np.zeros((n_steps, nw_max), dtype=np.int64)
        sel = order[wrank < nw_max]
        W[st[sel], slot_of_uk[sel]] = uk[sel] % wmod
        Ws.append(W)
        if not remaining.any():
            break
    if not Ws:
        Ws = [np.zeros((n_steps, nw_max), dtype=np.int64)]
    return pass_of, slot_of, np.stack(Ws)


class _FinalLevel:
    """Instance-based fixed-position reduction: output grid cell
    (r//128, r%128) IS y[r] — the whole SpMV finishes on device with no
    XLA scatter and no cross-pass sum.

    Children (per-row partials at arbitrary positions of the combined
    chunk-sum vector) are placed by a greedy: the output is divided into
    blocks of ``tps`` out tiles; each block gets one or more grid-step
    *instances*, each granting every row 8 gather slots and the step up
    to MAX_NW dynamically chosen aligned x-windows.  Instances of the
    same block are consecutive in the grid, so the out block stays
    VMEM-resident and accumulates (first instance initializes it); blocks
    whose children fit one instance pay exactly one step.  A residue
    matching (same constraint as the forward pack) assigns sublane slots;
    leftovers spill to a small XLA scatter."""

    MAX_NW = 8            # layout cap (drain encoding head-room)
    NW_CANDIDATES = (4, 8)
    G_CANDIDATES = (2, 4, 8)
    TPS_CANDIDATES = (64, 32, 16, 8)

    def __init__(self, step_meta, cell_idx, route, n_steps, tiles_per_step,
                 G, nw, nt_pad, x_pad_rows, spill_pos, spill_row):
        self.step_meta = np.asarray(step_meta)
        self.cell_idx = np.asarray(cell_idx)
        self.route = np.asarray(route)
        self.n_steps = n_steps
        self.tiles_per_step = tiles_per_step
        self.G = G
        self.nw = nw
        self.nt_pad = nt_pad
        self.x_pad_rows = x_pad_rows
        self.spill_pos = np.asarray(spill_pos, np.int32)
        self.spill_row = np.asarray(spill_row, np.int32)
        self.n_spills = int(spill_pos.size)

    @classmethod
    def build(cls, chunk_row, nr_rows,
              max_spill_frac: float = 0.2, force=None):
        """force=(nw, G, tps) pins the configuration (the distributed
        layer needs uniform shapes across shards)."""
        valid = np.flatnonzero(chunk_row != nr_rows)
        rows_all = chunk_row[valid].astype(np.int64)
        pos_all = valid.astype(np.int64)
        n_children = rows_all.shape[0]
        n_tiles = max(1, -(-nr_rows // LANES))

        # choose (windows/step, window size, tiles/step) by a measured
        # cost model (TPU v5e): per metadata tile ~(3 + 0.6*nw*G) ns (the
        # select chain dominates), per window DMA ~6*nw*G ns/instance,
        # per spilled child ~8 ns of XLA scatter.  The search runs on a
        # row-range subsample and extrapolates, so pack time stays O(nnz).
        if force is not None:
            nw, G_u, tps = force
            nt_pad = -(-n_tiles // tps) * tps
            return cls._build_with(chunk_row, nr_rows,
                                   max_spill_frac, nw, G_u, tps, nt_pad,
                                   rows_all, pos_all, n_children)

        def eval_cand(rows_c, pos_c, nw_c, G_u, tps, row_cap, scale):
            n_blk = max(1, -(-row_cap // (LANES * tps)))
            o_of = (rows_c // LANES) // tps
            p_of, _, _ = _assign_passes(rows_c, pos_c, o_of, G_u * 1024,
                                        nw_c, 4, n_blk)
            spills = int((p_of < 0).sum())
            extra = len(np.unique(
                p_of[p_of > 0].astype(np.int64) * n_blk
                + o_of[p_of > 0]))
            n_inst = n_blk + extra
            return scale * (n_inst * tps * (3.0 + 0.6 * nw_c * G_u)
                            + n_inst * (50.0 + 6.0 * nw_c * G_u)
                            + 8.0 * spills)

        full_builds = {}    # (nw, G, tps) -> full-set native arrays

        def eval_native(rows_c, pos_c, nw_c, G_u, tps, row_cap, scale):
            from ..native.final import final_build_native
            ntp = max(1, -(-row_cap // (LANES * tps))) * tps
            order = np.argsort(rows_c, kind="stable")
            built = final_build_native(
                rows_c[order].astype(np.int32), pos_c[order], ntp, tps,
                G_u, nw_c)
            if row_cap >= nr_rows:
                full_builds[(nw_c, G_u, tps)] = built
            meta, _, _, sp, _ = built
            n_inst = meta.shape[0]
            return scale * (n_inst * tps * (3.0 + 0.6 * nw_c * G_u)
                            + n_inst * (50.0 + 6.0 * nw_c * G_u)
                            + 8.0 * sp.shape[0])

        try:
            from ..native.final import available as _nat_avail
            use_native_eval = _nat_avail()
        except Exception:
            use_native_eval = False
        evaluate = eval_native if use_native_eval else eval_cand

        # rank candidates on a row-range subsample, then re-evaluate the
        # leaders on the full children set (subsample spill estimates are
        # noisy)
        sub_rows = min(nr_rows, 16 * LANES * CHUNK)     # <= 16384 rows
        sub = rows_all < sub_rows
        rows_s, pos_s = rows_all[sub], pos_all[sub]
        scale = max(1.0, n_children / max(int(sub.sum()), 1))
        cands = []
        for nw_c in cls.NW_CANDIDATES:
            for G_u in cls.G_CANDIDATES:
                for tps in cls.TPS_CANDIDATES:
                    # small steps pay a fixed per-step cost; only consider
                    # them when the output itself is tiny
                    if tps > max(8, n_tiles) or (tps < 32 and
                                                 n_tiles >= 32):
                        continue
                    cost = evaluate(rows_s, pos_s, nw_c, G_u, tps,
                                    min(sub_rows, nr_rows), scale)
                    cands.append((cost, tps, G_u, nw_c))
        if not cands:
            return None
        cands.sort()
        if sub_rows < nr_rows and len(cands) > 1:
            top = [evaluate(rows_all, pos_all, nw_c, G_u, tps, nr_rows,
                            1.0) + 0 * i
                   for i, (_, tps, G_u, nw_c) in enumerate(cands[:3])]
            best_i = int(np.argmin(top))
            _, tps, G_u, nw = cands[best_i]
        else:
            _, tps, G_u, nw = cands[0]
        nt_pad = -(-n_tiles // tps) * tps
        return cls._build_with(chunk_row, nr_rows,
                               max_spill_frac, nw, G_u, tps, nt_pad,
                               rows_all, pos_all, n_children,
                               prebuilt=full_builds.get((nw, G_u, tps)))

    @classmethod
    def _build_with(cls, chunk_row, nr_rows, max_spill_frac,
                    nw, G_u, tps, nt_pad, rows_all, pos_all, n_children,
                    prebuilt=None):
        native = cls._build_native(chunk_row, nr_rows,
                                   max_spill_frac, nw, G_u, tps, nt_pad,
                                   rows_all, pos_all, n_children,
                                   prebuilt=prebuilt)
        if native is not None:
            return native

        win = G_u * 1024
        R = nt_pad * LANES
        n_blocks = nt_pad // tps
        o_of_all = (rows_all // LANES) // tps

        # assignment + residue matching; one retry on fresh instances
        placements = []   # (pos, row, seq, slot, cell_val)
        W_of_seq = {}     # (seq, o) -> window row (nw,)
        seq_off = 0
        rem = np.arange(n_children)
        for p_cap in (6, 2):
            if rem.size == 0:
                break
            rows, pos, o_of = rows_all[rem], pos_all[rem], o_of_all[rem]
            p_of, w_slot, W = _assign_passes(rows, pos, o_of, win, nw,
                                             p_cap, n_blocks)
            a = p_of >= 0
            if not a.any():
                break
            seq = p_of[a].astype(np.int64) + seq_off
            rows2 = rows[a] + seq * R
            local_stripe = (pos[a] // STRIPE
                            - W[p_of[a], o_of[a], w_slot[a]]
                            * (CHUNK * G_u))
            cell_val = (w_slot[a].astype(np.int64) * (CHUNK * G_u)
                        + local_stripe)
            rank2, _ = _rank_in_group(rows2)
            slot = _match_tiles((seq_off + W.shape[0]) * nt_pad, rows2,
                                rank2, pos[a] % STRIPE, cell_val,
                                np.ones(rows2.shape[0], dtype=bool))
            placed = slot >= 0
            placements.append((pos[a][placed], rows[a][placed],
                               seq[placed], slot[placed].astype(np.int64),
                               cell_val[placed]))
            for p in range(W.shape[0]):
                for o in range(n_blocks):
                    W_of_seq[(p + seq_off, o)] = W[p, o]
            seq_off += W.shape[0]
            keep = np.ones(rem.size, dtype=bool)
            keep[np.flatnonzero(a)[placed]] = False
            rem = rem[keep]

        n_spill = rem.size
        if n_children and n_spill / n_children > max_spill_frac:
            return None

        # instance list: (o, seq) pairs with children, plus (o, 0) always
        inst_keys = set((int(o), 0) for o in range(n_blocks))
        for ppos, prow, pseq, pslot, pcell in placements:
            po = (prow // LANES) // tps
            inst_keys.update(zip(po.tolist(), pseq.tolist()))
        inst_list = sorted(inst_keys)              # grouped by o, seq asc
        n_steps = len(inst_list)
        inst_step = {}
        step_meta = np.zeros((n_steps, nw + 2), dtype=np.int64)
        for i, (o, s) in enumerate(inst_list):
            inst_step[(o, s)] = i
            step_meta[i, :nw] = W_of_seq.get((s, o), 0)
            step_meta[i, nw] = 1 if s == 0 else 0   # (o, 0) always exists
            step_meta[i, nw + 1] = o

        drain = np.int16(nw * CHUNK * G_u)
        cells = np.full((n_steps * tps, CHUNK, LANES), drain,
                        dtype=np.int16)
        route = np.zeros((n_steps * tps, CHUNK, LANES), dtype=np.int8)
        route_set = np.zeros((n_steps * tps, CHUNK, LANES), dtype=bool)
        for ppos, prow, pseq, pslot, pcell in placements:
            po = (prow // LANES) // tps
            st = np.array([inst_step[(int(o), int(s))]
                           for o, s in zip(po, pseq)], dtype=np.int64)
            gt = st * tps + (prow // LANES) % tps
            l_of = prow % LANES
            r_of = ppos % STRIPE
            route[gt, pslot, l_of] = r_of
            route_set[gt, pslot, l_of] = True
            cells[gt, pslot, r_of] = pcell
        # unused stream positions route to a drain cell of their sublane
        cell_free = cells == drain                     # (gt, s, r)
        free_r = np.argmax(cell_free, axis=2).astype(np.int8)
        gt_i, s_i, l_i = np.nonzero(~route_set)
        route[gt_i, s_i, l_i] = free_r[gt_i, s_i]

        w_max = int(step_meta[:, :nw].max()) if n_steps else 0
        x_pad_rows = (w_max + 1) * CHUNK * G_u
        x_pad_rows = max(x_pad_rows,
                         -(-int(chunk_row.shape[0]) // STRIPE))
        x_pad_rows = -(-x_pad_rows // (CHUNK * G_u)) * (CHUNK * G_u)
        return cls(step_meta.astype(np.int32),
                   cells.reshape(-1, LANES), route.reshape(-1, LANES),
                   n_steps, tps, G_u, nw, nt_pad, x_pad_rows,
                   pos_all[rem].astype(np.int32),
                   rows_all[rem].astype(np.int32))

    @classmethod
    def _build_native(cls, chunk_row, nr_rows, max_spill_frac,
                      nw, G_u, tps, nt_pad, rows_all, pos_all,
                      n_children, prebuilt=None):
        """C++ builder (native/final_builder.cpp): assignment + residue
        matching + materialization in one sequential pass.  Returns None
        (falling back to the NumPy builder) when the library is absent or
        spills exceed the budget."""
        if prebuilt is not None:
            step_meta, cells, route, spill_pos, spill_row = prebuilt
        else:
            try:
                from ..native.final import available, final_build_native
                if not available():
                    return None
            except Exception:
                return None
            order = np.argsort(rows_all, kind="stable")
            (step_meta, cells, route,
             spill_pos, spill_row) = final_build_native(
                rows_all[order].astype(np.int32), pos_all[order],
                nt_pad, tps, G_u, nw)
        if n_children and spill_pos.shape[0] / n_children > max_spill_frac:
            return None
        n_steps = step_meta.shape[0]
        w_max = int(step_meta[:, :nw].max()) if n_steps else 0
        x_pad_rows = (w_max + 1) * CHUNK * G_u
        x_pad_rows = max(x_pad_rows,
                         -(-int(chunk_row.shape[0]) // STRIPE))
        x_pad_rows = -(-x_pad_rows // (CHUNK * G_u)) * (CHUNK * G_u)
        return cls(step_meta, cells, route, n_steps, tps, G_u, nw, nt_pad,
                   x_pad_rows, spill_pos, spill_row)


class _FinalLevelV2:
    """Flat fixed-position reduction over row-major chunk positions.

    Children of output tile ot (rows [ot*128, ot*128+128)) within window
    block w occupy a contiguous position range (the pack emits chunks
    row-major per block; first-fit backfill jitters the range by at most
    max_open tiles), so each (out tile, w) needs a single GL_f-group
    dynamic window — no greedy window search, no coverage-driven
    instances.  Rows with more than 8 children per pass get additional
    passes (consecutive accumulating instances of the same out block);
    rare residue-matching losers and over-span children spill to a small
    XLA scatter."""

    PASS_CAP = 4

    def __init__(self, step_meta, tile_bases, cell_idx, route, n_steps,
                 tiles_per_step, GL_f, nwin, GS, nt_pad, x_pad_rows,
                 spill_pos, spill_row):
        self.step_meta = np.asarray(step_meta)
        self.tile_bases = np.asarray(tile_bases)
        self.cell_idx = np.asarray(cell_idx)
        self.route = np.asarray(route)
        self.n_steps = n_steps
        self.tiles_per_step = tiles_per_step
        self.GL_f = GL_f
        self.nwin = nwin
        self.GS = GS
        self.nt_pad = nt_pad
        self.x_pad_rows = x_pad_rows
        self.spill_pos = np.asarray(spill_pos, np.int32)
        self.spill_row = np.asarray(spill_row, np.int32)
        self.n_spills = int(spill_pos.size)


    @classmethod
    def build(cls, chunk_row, nr_rows, sections, planes,
              max_spill_frac: float = 0.02, tiles_per_step: int = 64):
        nwin = int(sections.shape[0])
        if nwin > 8:
            return None                      # chain too long: legacy wins
        valid = np.flatnonzero(chunk_row != nr_rows)
        rows_all = chunk_row[valid].astype(np.int64)
        pos_all = valid.astype(np.int64)
        n_children = rows_all.shape[0]
        n_tiles_out = max(1, -(-nr_rows // LANES))
        tps = min(tiles_per_step, max(8, n_tiles_out))
        nt_pad = -(-n_tiles_out // tps) * tps
        n_blocks = nt_pad // tps
        if n_children == 0:
            return None

        # children sorted by (row, pos); pos is ascending within a row
        order = np.argsort(rows_all, kind="stable")
        rows = rows_all[order]
        pos = pos_all[order]
        rank, _ = _rank_in_group(rows)
        pass_of = rank // CHUNK
        spill = pass_of >= cls.PASS_CAP

        # window block of each child (position ranges from pack sections;
        # positions per tile = 128 chunk lanes x planes)
        block_pos = sections[:, 0] * (LANES * planes)
        w_of = np.searchsorted(block_pos, pos, side="right") - 1
        ot = rows // LANES
        groups = pos // (CHUNK * STRIPE)             # 1024-position groups
        key_tw = ot * nwin + w_of

        # per (out tile, w) group range of children
        big = 1 << 30
        ming = np.full(nt_pad * nwin, big, dtype=np.int64)
        maxg = np.full(nt_pad * nwin, -1, dtype=np.int64)
        live = ~spill
        np.minimum.at(ming, key_tw[live], groups[live])
        np.maximum.at(maxg, key_tw[live], groups[live])

        # GL_f: groups a tile-window slice covers (pow2, cap 8) — sized
        # to the p90 of per-(tile, w) needs; stragglers (first-fit
        # backfill jitter) retry in later passes with their own bases
        need = maxg - np.where(ming == big, maxg, ming) + 1
        nz_need = need[maxg >= 0]
        need90 = int(np.percentile(nz_need, 90)) if nz_need.size else 1
        GL_f = 1
        while GL_f < min(need90, 8):
            GL_f *= 2

        # staging: per (out block, window) TWO consecutive GS-group
        # blocks at bi and bi+1 (block-quantized BlockSpec indices cannot
        # start at arbitrary offsets; the pair makes any range of width
        # <= GS reachable regardless of alignment).  Children pick the
        # sub-window their group falls in; per-(tile, sub-window) bases
        # stay in [0, GS - GL_f].
        o_of_tw = (np.arange(nt_pad * nwin) // nwin) // tps
        key_ow = o_of_tw * nwin + (np.arange(nt_pad * nwin) % nwin)
        mn = np.full(n_blocks * nwin, big, dtype=np.int64)
        mx = np.full(n_blocks * nwin, -1, dtype=np.int64)
        has = ming < big
        np.minimum.at(mn, key_ow[has], ming[has])
        np.maximum.at(mx, key_ow[has], maxg[has])
        spread = int(np.where(mx >= 0,
                              mx - np.where(mn == big, mx, mn),
                              0).max()) if mx.size else 0
        # VMEM budget for the 2*nwin staged blocks (~4 MB, double-buffered
        # by the pipeline)
        gs_cap = 8
        while 2 * nwin * (gs_cap * 2) * CHUNK * LANES * 4 <= (4 << 20):
            gs_cap *= 2
        need_gs = max(8, spread + 1)
        if need_gs > gs_cap:
            return None          # block spread too wide: legacy wins
        GS = 8
        while GS < need_gs:
            GS *= 2
        bi = np.where(mx < 0, 0, np.where(mn == big, 0, mn) // GS)

        # sub-window of each child (global; bases are per pass)
        off = groups - bi[key_ow[key_tw]] * GS
        off = np.where(live, off, 0)
        sub_of = off // GS                          # 0 or 1
        off_sub = off - sub_of * GS                 # in [0, GS)
        w2_of = 2 * w_of + sub_of
        nwin2 = 2 * nwin
        key_tw2 = ot * nwin2 + w2_of

        # pass loop: each pass is a fresh instance with its OWN
        # per-(tile, sub-window) bases and cell table, so both base
        # stragglers (beyond the pass's GL_f slice) and residue-matching
        # losers retry in the next pass instead of spilling
        res = pos % STRIPE
        slot = np.full(rows.shape[0], -1, dtype=np.int8)
        cell_val = np.zeros(rows.shape[0], dtype=np.int64)
        final_pass = np.full(rows.shape[0], cls.PASS_CAP, dtype=np.int64)
        cur_pass = np.where(live, pass_of, cls.PASS_CAP).astype(np.int64)
        base_rounds = np.zeros((cls.PASS_CAP, nt_pad * nwin2),
                               dtype=np.int64)
        for r in range(cls.PASS_CAP):
            idx = np.flatnonzero(live & (cur_pass == r))
            if idx.size == 0:
                continue
            ming2 = np.full(nt_pad * nwin2, big, dtype=np.int64)
            np.minimum.at(ming2, key_tw2[idx], off_sub[idx])
            base_r = np.minimum(np.where(ming2 == big, 0, ming2),
                                GS - GL_f)
            base_rounds[r] = base_r
            over = off_sub[idx] - base_r[key_tw2[idx]] >= GL_f
            cur_pass[idx[over]] = r + 1
            idx = idx[~over]
            if idx.size == 0:
                continue
            # a round may hold natives + retries: defer members beyond
            # the chunk's 8 slots (the matcher needs distinct ranks)
            rk, _ = _rank_in_group(rows[idx])
            toomany = rk >= CHUNK
            if toomany.any():
                cur_pass[idx[toomany]] = r + 1
                idx, rk = idx[~toomany], rk[~toomany]
                if idx.size == 0:
                    continue
            rel = (off_sub[idx] - base_r[key_tw2[idx]]) * CHUNK \
                + (pos[idx] // STRIPE) % CHUNK
            cv = w2_of[idx] * (CHUNK * GL_f) + rel
            s = _match_tiles(nt_pad, rows[idx], rk % CHUNK, res[idx],
                             cv, np.ones(idx.size, dtype=bool))
            won = s >= 0
            slot[idx[won]] = s[won]
            cell_val[idx[won]] = cv[won]
            final_pass[idx[won]] = r
            cur_pass[idx[~won]] = r + 1
        pass_of = final_pass
        spill |= live & (slot < 0)
        live = ~spill
        if n_children and spill.sum() / n_children > max(
                max_spill_frac, 64 / n_children):
            return None

        # instance (step) list: (o, pass) pairs with children, plus (o, 0)
        o_of_child = (ot[live]).astype(np.int64) // tps
        inst_keys = set((int(o), 0) for o in range(n_blocks))
        inst_keys.update(zip(o_of_child.tolist(),
                             pass_of[live].tolist()))
        inst_list = sorted(inst_keys)
        n_steps = len(inst_list)
        inst_step = {k: i for i, k in enumerate(inst_list)}
        step_meta = np.zeros((n_steps, nwin2 + 2), dtype=np.int32)
        tile_bases = np.zeros((n_steps, tps * nwin2), dtype=np.int32)
        bi2 = bi.reshape(n_blocks, nwin)
        base4 = base_rounds.reshape(cls.PASS_CAP, nt_pad, nwin2)
        for i, (o, p) in enumerate(inst_list):
            step_meta[i, 0:nwin2:2] = bi2[o]
            step_meta[i, 1:nwin2:2] = bi2[o] + 1
            step_meta[i, nwin2] = 1 if p == 0 else 0
            step_meta[i, nwin2 + 1] = o
            tile_bases[i] = base4[p, o * tps:(o + 1) * tps].reshape(-1)

        drain = np.int16(nwin2 * CHUNK * GL_f)
        cells = np.full((n_steps * tps, CHUNK, LANES), drain,
                        dtype=np.int16)
        route_a = np.zeros((n_steps * tps, CHUNK, LANES), dtype=np.int8)
        route_set = np.zeros((n_steps * tps, CHUNK, LANES), dtype=bool)
        li = np.flatnonzero(live)
        st = np.array([inst_step[(int(o), int(p))]
                       for o, p in zip(ot[li] // tps, pass_of[li])],
                      dtype=np.int64)
        gt = st * tps + (ot[li] % tps)
        l_of = rows[li] % LANES
        r_of = res[li]
        s_of = slot[li].astype(np.int64)
        route_a[gt, s_of, l_of] = r_of
        route_set[gt, s_of, l_of] = True
        cells[gt, s_of, r_of] = cell_val[li]
        # unused stream positions route to a drain cell of their sublane
        cell_free = cells == drain
        free_r = np.argmax(cell_free, axis=2).astype(np.int8)
        gt_i, s_i, l_i = np.nonzero(~route_set)
        route_a[gt_i, s_i, l_i] = free_r[gt_i, s_i]

        # cover the bi+1 sub-blocks: pad the position vector to
        # (max bi + 2) staged blocks of GS groups
        x_pad_rows = int((bi.max() + 2 if bi.size else 2) * GS * CHUNK)
        x_pad_rows = max(x_pad_rows,
                         -(-int(chunk_row.shape[0]) // STRIPE))
        x_pad_rows = -(-x_pad_rows // (CHUNK * GS)) * (CHUNK * GS)
        sp = np.flatnonzero(spill)
        return cls(step_meta, tile_bases,
                   cells.reshape(-1, LANES), route_a.reshape(-1, LANES),
                   n_steps, tps, GL_f, nwin2, GS, nt_pad, x_pad_rows,
                   pos[sp].astype(np.int32), rows[sp].astype(np.int32))


class _FinalLevelMulti:
    """Sum of per-section-group flat V2 finals: column-wide matrices
    (> 8 blocks) split their sections into groups of <= 8; each group's
    children reduce through an independent _FinalLevelV2 over the same
    position vector (others masked to the trap), and y is the sum of
    the group grids.  Finish cost stays child-count-linear instead of
    falling off the legacy 2x cliff."""

    def __init__(self, levels):
        self.levels = levels
        self.n_spills = sum(l.n_spills for l in levels)

    @classmethod
    def build(cls, chunk_row, nr_rows, sections, planes,
              group: int = 8):
        n_sec = sections.shape[0]
        levels = []
        for g0 in range(0, n_sec, group):
            sec_g = sections[g0:g0 + group]
            lo = int(sec_g[0, 0]) * (LANES * planes)
            hi = int(sec_g[-1, 1]) * (LANES * planes)
            cr = np.full_like(chunk_row, nr_rows)
            cr[lo:hi] = chunk_row[lo:hi]
            if not (cr != nr_rows).any():
                continue
            lvl = _FinalLevelV2.build(cr, nr_rows, sec_g, planes)
            if lvl is None:
                return None
            levels.append(lvl)
        return cls(levels) if levels else None


class FinishPlan:
    """The chunk -> row reduction of one pack (``GStreamDevice._build_finish``
    of the JAX package): F-level packs whose outputs extend the position
    vector, then one final level; ``chunk_row`` (the row of every position,
    the trap ``nr_rows`` for none) is kept for the segment-sum route taken
    when no final can be built."""

    def __init__(self, flevels: List[GStreamMatrix], final,
                 chunk_row: Optional[np.ndarray]):
        self.flevels = flevels
        self.final = final
        self.chunk_row = chunk_row


def build_finish(packed: GStreamMatrix) -> FinishPlan:
    """Build the chunk->row reduction: heavy rows (> HEAVY_CAP partials)
    get incidence F levels whose outputs extend the position space; all
    remaining partials are consumed by one multi-pass fixed-position final
    level (output grid cell (r//128, r%128) IS y[r]).  Leftover spills
    take a small scatter-add; if the final cannot be built at all, the
    whole reduction takes a segment-sum over the combined vector."""
    finish = []
    trap = packed.nr_rows
    chunk_row = packed.chunk_row.reshape(-1).astype(np.int64).copy()
    if packed.ordered:
        # row-major positions: the flat V2 final consumes everything
        # in one level (per-out-tile dynamic windows); heavy rows
        # (> PASS_CAP passes) would spill it back to legacy
        counts = np.bincount(
            chunk_row[chunk_row != trap], minlength=1)
        if counts.size == 0 or counts.max() <= \
                _FinalLevelV2.PASS_CAP * CHUNK:
            final = _FinalLevelV2.build(
                chunk_row, trap, packed.sections, packed.planes)
            if final is None and packed.sections.shape[0] > 8:
                # wide-column matrices (> 8 column blocks): split the
                # sections into groups of <= 8 and sum one flat V2 final
                # per group
                final = _FinalLevelMulti.build(
                    chunk_row, trap, packed.sections, packed.planes)
            if final is not None:
                return FinishPlan([], final, None)
    for _ in range(3):
        valid = chunk_row != trap
        if not valid.any():
            break
        counts = np.bincount(chunk_row[valid], minlength=trap)
        if counts.size == 0 or counts.max() <= HEAVY_CAP:
            break
        heavy = counts > HEAVY_CAP
        hmask = np.zeros(chunk_row.shape[0], dtype=bool)
        hmask[valid] = heavy[chunk_row[valid]]
        hpos = np.flatnonzero(hmask)
        f_csr = CSRMatrix.from_coo(
            chunk_row[hpos].astype(np.int64), hpos.astype(np.int64),
            np.ones(hpos.shape[0], np.float32),
            trap, chunk_row.shape[0], sum_duplicates=False)
        fp = pack_gstream(f_csr, shuffle_lanes=False)
        finish.append(fp)
        chunk_row[hpos] = trap   # consumed by the F level
        chunk_row = np.concatenate(
            [chunk_row, fp.chunk_row.reshape(-1).astype(np.int64)])
    final = _FinalLevel.build(chunk_row, trap)
    # pathological placement: segment-sum over the combined vector
    return FinishPlan(finish, final,
                      chunk_row.astype(np.int32) if final is None else None)
