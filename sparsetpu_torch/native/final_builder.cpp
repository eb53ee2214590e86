// Native builder for the fixed-position final reduction level.
//
// C++ port of the hot pack-time phases of _FinalLevel.build
// (pack/final_levels.py; after kernels/spmv_pallas.py of the JAX package): greedy instance/window/fan-in
// assignment plus the per-(tile, sublane) residue matching, followed by
// materialization of the cells / route streams.  This is the framework's
// equivalent of the reference's native host repack (csr_hw.cpp) for the
// *reduction* artifact; the (nw, G, tps) configuration search stays in
// Python (it runs on a subsample).
//
// Contract (mirrors the Python builder):
//   * children = (row, pos) pairs, pos indexes the flat chunk-sum vector;
//   * output block o = (row / 128) / tps; instances of a block are
//     consecutive grid steps; instance grants each row 8 gather slots and
//     the step up to nw aligned x-windows of G*1024 positions;
//   * cell value = window_slot * 8G + (pos/128 - window*8G), stored at
//     (tile, sublane, pos%128); route[tile, sublane, row%128] = pos%128;
//   * unused cells carry the drain value nw*8G; empty stream positions
//     route to a free (drain) residue of their sublane.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kChunk = 8;
constexpr int kLanes = 128;

struct Member {          // one placed child of a lane-chunk
  int res;
  int32_t cell_val;
  int64_t pos;
};

struct LaneChunk {
  int count = 0;
  Member m[kChunk];
  int slot_of[kChunk];   // member -> sublane slot
};

struct FinalTile {
  int32_t cell[kChunk][kLanes];      // claimed cell value; -1 free
  int16_t refc[kChunk][kLanes];      // sharers per cell
  LaneChunk lanes[kLanes];
  void init() {
    std::memset(cell, 0xff, sizeof(cell));
    std::memset(refc, 0, sizeof(refc));
  }
};

struct Instance {
  int o;
  int seq;
  std::vector<int64_t> windows;      // <= nw
  std::vector<FinalTile> tiles;      // tps tiles
  Instance(int o_, int seq_, int tps) : o(o_), seq(seq_) {
    tiles.resize(tps);
    for (auto& t : tiles) t.init();
  }
  int window_slot(int64_t w, int nw) {
    for (size_t i = 0; i < windows.size(); ++i)
      if (windows[i] == w) return static_cast<int>(i);
    if (static_cast<int>(windows.size()) < nw) {
      windows.push_back(w);
      return static_cast<int>(windows.size()) - 1;
    }
    return -1;
  }
};

// Augmenting-path matcher over one lane-chunk's members (same scheme as
// packer.cpp's ChunkMatcher, against the final tile's cell state).
struct Matcher {
  int n;
  const Member* mem[kChunk];
  int slot_of[kChunk];
  int elem_of[kChunk];
  bool visited[kChunk];
  FinalTile* tile;

  bool candidate(int e, int s) const {
    int32_t c = tile->cell[s][mem[e]->res];
    return c == -1 || c == mem[e]->cell_val;
  }
  bool augment(int e) {
    for (int s = 0; s < kChunk; ++s) {
      if (visited[s] || !candidate(e, s)) continue;
      visited[s] = true;
      if (elem_of[s] < 0 || augment(elem_of[s])) {
        elem_of[s] = e;
        slot_of[e] = s;
        return true;
      }
    }
    return false;
  }
  bool match(FinalTile* t) {
    tile = t;
    for (int i = 0; i < kChunk; ++i) slot_of[i] = elem_of[i] = -1;
    for (int e = 0; e < n; ++e) {
      for (int s = 0; s < kChunk; ++s) visited[s] = false;
      if (!augment(e)) return false;
    }
    return true;
  }
};

void release(FinalTile& t, int s, int res) {
  if (--t.refc[s][res] == 0) t.cell[s][res] = -1;
}

void claim(FinalTile& t, int s, int res, int32_t v) {
  t.cell[s][res] = v;
  ++t.refc[s][res];
}

struct BuildState {
  std::vector<Instance*> instances;   // emission order: (o asc, seq asc)
  std::vector<int64_t> spill_pos;
  std::vector<int32_t> spill_row;
  int tps, G, nw, n_blocks;
  ~BuildState() { for (auto* i : instances) delete i; }
};

}  // namespace

extern "C" {

// rows/pos sorted by row (pos order within a row arbitrary).  Returns the
// instance (grid step) count, or -1 on error.
long long stpu_final_build(const int32_t* rows, const int64_t* pos,
                           long long n, long long nt_pad, int tps, int G,
                           int nw, int inst_cap, void** out_handle) {
  if (tps <= 0 || G <= 0 || nw <= 0 || nw > 8) return -1;
  auto* st = new BuildState();
  st->tps = tps;
  st->G = G;
  st->nw = nw;
  st->n_blocks = static_cast<int>(nt_pad / tps);
  const int64_t win = static_cast<int64_t>(G) * 1024;
  const int32_t stripes_per_win = 8 * G;

  // group children by output block (rows sorted -> o non-decreasing)
  std::vector<std::vector<Instance*>> by_o(st->n_blocks);
  Matcher mt;
  long long i = 0;
  while (i < n) {
    const int o = static_cast<int>((rows[i] / kLanes) / tps);
    long long j = i;
    while (j < n && static_cast<int>((rows[j] / kLanes) / tps) == o) ++j;
    auto& insts = by_o[o];
    // popularity-ordered windows for instance 0 of this block
    std::unordered_map<int64_t, int> wcount;
    for (long long k = i; k < j; ++k) ++wcount[pos[k] / win];
    std::vector<std::pair<int, int64_t>> byc;
    byc.reserve(wcount.size());
    for (auto& kv : wcount) byc.push_back({-kv.second, kv.first});
    std::sort(byc.begin(), byc.end());
    insts.push_back(new Instance(o, 0, tps));
    for (int w = 0; w < nw && w < static_cast<int>(byc.size()); ++w)
      insts[0]->windows.push_back(byc[w].second);

    for (long long k = i; k < j; ++k) {
      const int32_t row = rows[k];
      const int tloc = (row / kLanes) % tps;
      const int lane = row % kLanes;
      const int64_t w = pos[k] / win;
      const int res = static_cast<int>(pos[k] % kLanes);
      bool placed = false;
      for (size_t ii = 0; ii < insts.size() && !placed; ++ii) {
        Instance* inst = insts[ii];
        FinalTile& tile = inst->tiles[tloc];
        LaneChunk& lc = tile.lanes[lane];
        if (lc.count >= kChunk) continue;
        const int ws = inst->window_slot(w, nw);
        if (ws < 0) continue;
        const int32_t cell_val =
            ws * stripes_per_win +
            static_cast<int32_t>(pos[k] / kLanes - w * stripes_per_win);
        // tentative: release current members, rematch with the new one
        for (int e = 0; e < lc.count; ++e)
          release(tile, lc.slot_of[e], lc.m[e].res);
        Member cand{res, cell_val, pos[k]};
        mt.n = lc.count + 1;
        for (int e = 0; e < lc.count; ++e) mt.mem[e] = &lc.m[e];
        mt.mem[lc.count] = &cand;
        if (mt.match(&tile)) {
          lc.m[lc.count] = cand;
          for (int e = 0; e <= lc.count; ++e) {
            lc.slot_of[e] = mt.slot_of[e];
            claim(tile, mt.slot_of[e], lc.m[e].res, lc.m[e].cell_val);
          }
          ++lc.count;
          placed = true;
        } else {
          // restore original placement
          for (int e = 0; e < lc.count; ++e)
            claim(tile, lc.slot_of[e], lc.m[e].res, lc.m[e].cell_val);
        }
      }
      if (!placed) {
        if (static_cast<int>(insts.size()) < inst_cap) {
          auto* inst = new Instance(o, static_cast<int>(insts.size()),
                                    tps);
          insts.push_back(inst);
          // retry on the fresh instance (always matches: empty tile)
          FinalTile& tile = inst->tiles[tloc];
          LaneChunk& lc = tile.lanes[lane];
          const int ws = inst->window_slot(w, nw);
          const int32_t cell_val =
              ws * stripes_per_win +
              static_cast<int32_t>(pos[k] / kLanes - w * stripes_per_win);
          lc.m[0] = Member{res, cell_val, pos[k]};
          lc.slot_of[0] = 0;
          lc.count = 1;
          claim(tile, 0, res, cell_val);
        } else {
          st->spill_pos.push_back(pos[k]);
          st->spill_row.push_back(row);
        }
      }
    }
    i = j;
  }

  // emission order: every block gets its (possibly empty) instance 0
  for (int o = 0; o < st->n_blocks; ++o) {
    if (by_o[o].empty()) by_o[o].push_back(new Instance(o, 0, tps));
    for (auto* inst : by_o[o]) st->instances.push_back(inst);
  }
  *out_handle = st;
  return static_cast<long long>(st->instances.size());
}

long long stpu_final_spills(void* handle) {
  return static_cast<long long>(
      static_cast<BuildState*>(handle)->spill_pos.size());
}

// step_meta (S, nw+2) i32; cells (S*tps*8, 128) i16; route same i8;
// spill_pos/spill_row (n_spills) i32/i32.
void stpu_final_copy(void* handle, int32_t* step_meta, int16_t* cells,
                     int8_t* route, int32_t* spill_pos,
                     int32_t* spill_row) {
  auto* st = static_cast<BuildState*>(handle);
  const int tps = st->tps, nw = st->nw;
  const int16_t drain = static_cast<int16_t>(nw * 8 * st->G);
  size_t si = 0;
  for (Instance* inst : st->instances) {
    int32_t* meta = step_meta + si * (nw + 2);
    for (int w = 0; w < nw; ++w)
      meta[w] = w < static_cast<int>(inst->windows.size())
                    ? static_cast<int32_t>(inst->windows[w]) : 0;
    meta[nw] = inst->seq == 0 ? 1 : 0;
    meta[nw + 1] = inst->o;
    for (int t = 0; t < tps; ++t) {
      FinalTile& tile = inst->tiles[t];
      int16_t* ce = cells + ((si * tps + t) * kChunk) * kLanes;
      int8_t* ro = route + ((si * tps + t) * kChunk) * kLanes;
      // defaults: drain cells, routes fixed up below
      for (int s = 0; s < kChunk; ++s)
        for (int r = 0; r < kLanes; ++r)
          ce[s * kLanes + r] =
              tile.cell[s][r] >= 0
                  ? static_cast<int16_t>(tile.cell[s][r]) : drain;
      // per sublane: first drain residue for empty stream positions
      int free_r[kChunk];
      for (int s = 0; s < kChunk; ++s) {
        free_r[s] = 0;
        for (int r = 0; r < kLanes; ++r)
          if (tile.cell[s][r] < 0) { free_r[s] = r; break; }
      }
      for (int l = 0; l < kLanes; ++l) {
        const LaneChunk& lc = tile.lanes[l];
        bool used[kChunk] = {false};
        for (int e = 0; e < lc.count; ++e) {
          ro[lc.slot_of[e] * kLanes + l] =
              static_cast<int8_t>(lc.m[e].res);
          used[lc.slot_of[e]] = true;
        }
        for (int s = 0; s < kChunk; ++s)
          if (!used[s]) ro[s * kLanes + l] = static_cast<int8_t>(free_r[s]);
      }
    }
    ++si;
  }
  for (size_t k = 0; k < st->spill_pos.size(); ++k) {
    spill_pos[k] = static_cast<int32_t>(st->spill_pos[k]);
    spill_row[k] = st->spill_row[k];
  }
}

void stpu_final_free(void* handle) {
  delete static_cast<BuildState*>(handle);
}

}  // extern "C"
