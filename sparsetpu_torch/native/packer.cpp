// Native GStream pack engine: the repack hot loop.
//
// Re-implements the residue-matching pack (pack/gather_stream.py)
// in C++, playing the role of the reference's host-side repack engine
// (csr_hw.cpp:190-318: create_block_matrix + generate_balanced_hw_submatrix,
// which the reference also keeps native for speed).  Differences from the
// NumPy fallback:
//   * per-chunk Hungarian (augmenting-path) matching instead of randomized
//     rounds -> a chunk is placed iff a perfect slot assignment exists;
//   * chunks flow into the first of K open tiles that accepts them instead
//     of fixed position -> higher fill, no global re-rounds;
//   * single pass, O(nnz * alpha) instead of NumPy's multi-round sweeps.
//
// Layout contract (must match gather_stream.py and the Pallas kernel):
//   chunk = q consecutive elements of one row (pads allowed), q = the
//     VF row-pad quantum in {1,2,4,8} (util.h:31-39);
//   tile  = 128*(8/q) chunks, plane-major: within-tile chunk w sits at
//     plane = w/128, lane = w%128, spanning sublanes [plane*q,(plane+1)*q);
//   cells[t][s][res] = x-stripe index for the element matched there;
//   route[t][s][l]   = res of the element at stream (s, l);
//   chunk_row is (n_tiles * 8/q, 128), plane-major per tile.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kChunk = 8;
constexpr int kLanes = 128;

struct Tile {
  // cell state: stripe claimed per (sublane, residue); -1 = free
  int32_t cell[kChunk][kLanes];
  float vals[kChunk][kLanes];
  int16_t cells16[kChunk][kLanes];
  int16_t route[kChunk][kLanes];
  int32_t chunk_row[kChunk][kLanes];  // [plane][lane]; planes = 8/q used
  int n_chunks = 0;
  int lane_seed = -1;
  int plane_cnt[kChunk] = {0};  // v2 small-q: chunks per plane
  // v2 (per-tile dynamic window base): group range of accepted chunks
  int glo = 1 << 30;
  int ghi = -1;

  void init(int32_t trap_row) {
    std::memset(cell, 0xff, sizeof(cell));        // -1
    std::memset(vals, 0, sizeof(vals));
    std::memset(cells16, 0, sizeof(cells16));
    std::memset(route, 0, sizeof(route));
    std::memset(plane_cnt, 0, sizeof(plane_cnt));
    for (int p = 0; p < kChunk; ++p)
      for (int l = 0; l < kLanes; ++l) chunk_row[p][l] = trap_row;
    n_chunks = 0;
    glo = 1 << 30;
    ghi = -1;
  }
};

struct PackState {
  std::vector<Tile*> done;
  std::vector<Tile*> open;
  int max_open;
  int32_t trap_row;

  ~PackState() {
    for (Tile* t : done) delete t;
    for (Tile* t : open) delete t;
  }
};

// Augmenting-path matching of one chunk's real elements onto the q slots
// of one plane.  cand(e, s) = slot s may serve element e: cell free or
// same stripe.  Slots are plane-relative; sub0 = plane * q.
struct ChunkMatcher {
  int q;
  int n_real;
  int res[kChunk];
  int32_t stripe[kChunk];
  int slot_of[kChunk];        // element -> slot
  int elem_of[kChunk];        // slot -> element (-1 free)
  bool visited[kChunk];
  const Tile* tile;
  int sub0;

  bool candidate(int e, int s) const {
    int32_t c = tile->cell[sub0 + s][res[e]];
    return c == -1 || c == stripe[e];
  }

  bool augment(int e) {
    for (int s = 0; s < q; ++s) {
      if (!candidate(e, s) || visited[s]) continue;
      visited[s] = true;
      if (elem_of[s] < 0 || augment(elem_of[s])) {
        elem_of[s] = e;
        slot_of[e] = s;
        return true;
      }
    }
    return false;
  }

  bool match(const Tile* t, int plane) {
    tile = t;
    sub0 = plane * q;
    for (int i = 0; i < kChunk; ++i) {
      slot_of[i] = -1;
      elem_of[i] = -1;
    }
    for (int e = 0; e < n_real; ++e) {
      for (int s = 0; s < q; ++s) visited[s] = false;
      if (!augment(e)) return false;
    }
    return true;
  }
};

void place_chunk(Tile* t, const ChunkMatcher& m, int pos,
                 const int32_t* prow, const int32_t* pcol, const float* pval,
                 const uint8_t* preal, int64_t base) {
  const int q = m.q;
  const int plane = pos / kLanes;
  const int lane = pos % kLanes;
  const int sub0 = plane * q;
  bool slot_used[kChunk] = {false};
  int e_real = 0;
  // reals first (matched), pads into leftover slots
  for (int k = 0; k < q; ++k) {
    if (!preal[base + k]) continue;
    int s = sub0 + m.slot_of[e_real];
    int r = m.res[e_real];
    t->cell[s][r] = m.stripe[e_real];
    t->cells16[s][r] = static_cast<int16_t>(m.stripe[e_real]);
    t->vals[s][lane] = pval[base + k];
    t->route[s][lane] = static_cast<int16_t>(r);
    slot_used[s - sub0] = true;
    ++e_real;
  }
  int free_s = 0;
  for (int k = 0; k < q; ++k) {
    if (preal[base + k]) continue;
    while (free_s < q && slot_used[free_s]) ++free_s;
    if (free_s < q) {
      t->vals[sub0 + free_s][lane] = 0.0f;
      t->route[sub0 + free_s][lane] = 0;
      slot_used[free_s] = true;
    }
  }
  t->chunk_row[plane][lane] = prow[base];
  t->n_chunks++;
}

}  // namespace

extern "C" {

// Pack one column block.  Elements are pre-padded (n_el % q == 0; each
// group of q is one row's chunk; preal marks real vs pad).  q is the
// row-pad quantum in {1,2,4,8}.  Returns the tile count and an opaque
// handle for copy-out, or -1 on error.
long long stpu_pack_block_q(const int32_t* prow, const int32_t* pcol,
                            const float* pval, const uint8_t* preal,
                            long long n_el, int32_t trap_row, int max_open,
                            int q, void** out_handle) {
  if (q < 1 || q > kChunk || kChunk % q != 0) return -1;
  if (n_el % q != 0 || max_open < 1) return -1;
  const int planes = kChunk / q;
  const int cap = planes * kLanes;  // chunks per tile
  auto* st = new PackState();
  st->max_open = max_open;
  st->trap_row = trap_row;

  ChunkMatcher m;
  m.q = q;
  const long long n_chunks = n_el / q;
  for (long long c = 0; c < n_chunks; ++c) {
    const int64_t base = c * q;
    m.n_real = 0;
    for (int k = 0; k < q; ++k) {
      if (!preal[base + k]) continue;
      m.res[m.n_real] = pcol[base + k] & (kLanes - 1);
      m.stripe[m.n_real] = pcol[base + k] >> 7;
      ++m.n_real;
    }
    bool placed = false;
    for (Tile* t : st->open) {
      if (t->n_chunks >= cap) continue;
      if (m.match(t, t->n_chunks / kLanes)) {
        place_chunk(t, m, t->n_chunks, prow, pcol, pval, preal, base);
        placed = true;
        break;
      }
    }
    if (!placed) {
      Tile* t = new Tile();
      t->init(trap_row);
      bool ok = m.match(t, 0);
      (void)ok;  // always true on an empty tile
      place_chunk(t, m, 0, prow, pcol, pval, preal, base);
      st->open.push_back(t);
    }
    // retire full / excess tiles (oldest first keeps a rolling window)
    while (!st->open.empty() &&
           (st->open.front()->n_chunks >= cap ||
            static_cast<int>(st->open.size()) > st->max_open)) {
      st->done.push_back(st->open.front());
      st->open.erase(st->open.begin());
    }
  }
  while (!st->open.empty()) {
    st->done.push_back(st->open.front());
    st->open.erase(st->open.begin());
  }
  *out_handle = st;
  return static_cast<long long>(st->done.size());
}

// Copy packed tiles out into caller-allocated arrays:
//   values (n_tiles*8, 128) f32, cells (n_tiles*8, 128) i16,
//   route (n_tiles*8, 128) i16, chunk_row (n_tiles*planes, 128) i32.
void stpu_pack_copy_q(void* handle, int q, float* values, int16_t* cells,
                      int16_t* route, int32_t* chunk_row) {
  auto* st = static_cast<PackState*>(handle);
  const int planes = kChunk / q;
  size_t ti = 0;
  for (Tile* t : st->done) {
    float* v = values + ti * kChunk * kLanes;
    int16_t* ce = cells + ti * kChunk * kLanes;
    int16_t* ro = route + ti * kChunk * kLanes;
    for (int s = 0; s < kChunk; ++s) {
      std::memcpy(v + s * kLanes, t->vals[s], sizeof(float) * kLanes);
      std::memcpy(ro + s * kLanes, t->route[s], sizeof(int16_t) * kLanes);
      std::memcpy(ce + s * kLanes, t->cells16[s], sizeof(int16_t) * kLanes);
    }
    for (int p = 0; p < planes; ++p)
      std::memcpy(chunk_row + (ti * planes + p) * kLanes, t->chunk_row[p],
                  sizeof(int32_t) * kLanes);
    ++ti;
  }
}

void stpu_pack_free(void* handle) {
  delete static_cast<PackState*>(handle);
}

// ---------------------------------------------------------------------------
// v2: per-tile dynamic window base (GStream v2).
//
// The kernel stages a full G-group x window per grid step but each tile
// gathers from only GL groups of it, starting at a per-tile base read from
// scalar-prefetch memory — so the select chain costs O(GL), not O(G)
// (measured: G=32 full chain 46 Gslot/s vs per-tile base 116 Gslot/s on
// v5e).  Pack-time obligations: every chunk's elements span < GL groups
// (runs are split greedily where they would not), and tiles only accept
// chunks keeping the tile's union group span < GL.  Cells are stored
// RELATIVE to the tile base.
// ---------------------------------------------------------------------------

namespace {

struct ChunkRef {
  int64_t start;
  int16_t len;
  int16_t glo, ghi;
  int32_t row;
};

struct PackV2State {
  std::vector<Tile*> done;
  std::vector<int> base;  // per done tile
  ~PackV2State() {
    for (Tile* t : done) delete t;
  }
};

void place_chunk_v2(Tile* t, const ChunkMatcher& m, int plane, int lane,
                    const int32_t* cols, const float* vals,
                    const ChunkRef& c) {
  const int q = m.q;
  const int sub0 = plane * q;
  bool slot_used[kChunk] = {false};
  for (int e = 0; e < c.len; ++e) {
    int s = sub0 + m.slot_of[e];
    int r = m.res[e];
    t->cell[s][r] = m.stripe[e];
    t->vals[s][lane] = vals[c.start + e];
    t->route[s][lane] = static_cast<int16_t>(r);
    slot_used[m.slot_of[e]] = true;
  }
  int free_s = 0;
  for (int e = c.len; e < q; ++e) {
    while (free_s < q && slot_used[free_s]) ++free_s;
    if (free_s < q) {
      t->vals[sub0 + free_s][lane] = 0.0f;
      t->route[sub0 + free_s][lane] = 0;
      slot_used[free_s] = true;
    }
  }
  t->chunk_row[plane][lane] = c.row;
  if (c.glo < t->glo) t->glo = c.glo;
  if (c.ghi > t->ghi) t->ghi = c.ghi;
  // n_chunks is owned by the caller (it also tracks plane cursors)
}

}  // namespace

// Pack one column block, v2 layout.  Inputs are the block's raw
// row-major-sorted triplets (cols local to the block, in [0, G*1024)).
// slab_rows > 0 orders chunks by (row/slab_rows, group) instead of
// (group): positions stay row-slab-contiguous, so the flat V2 final
// level applies, at a locality cost of ~log(slab/128) extra GL groups.
// lane_mode: 0 = rank order, 1 = per-tile 37-stride shuffle (odd stride
// is a lane bijection; decorrelates a row's lanes ACROSS tiles so the
// fused finish's per-residue capacity isn't blown — the classic path's
// _shuffle_chunk_lanes), 2 = row-keyed (lane = row & 127): every chunk
// of a row lands at ONE lane, so the scattered-regime stage-1 finish
// packs each row into a single conflict-free lane column (consecutive
// rows -> distinct lanes; see stpu_fused_finish).
// Returns the tile count; copy out with stpu_pack_copy_v2.
long long stpu_pack_v2(const int32_t* rows, const int32_t* cols,
                       const float* vals, long long n, int32_t trap_row,
                       int q, int GL, int G, int max_open, int slab_rows,
                       int lane_mode, void** out_handle) {
  if (q < 1 || q > kChunk || kChunk % q != 0) return -1;
  if (GL < 1 || GL > G || max_open < 1) return -1;
  const int planes = kChunk / q;
  const int cap = planes * kLanes;

  // pass 1: greedy span-limited chunking (split where a chunk would span
  // >= GL groups — the reference's row padding, csr_hw.cpp:108-114, plus
  // the v2 locality cut)
  std::vector<ChunkRef> chunks;
  chunks.reserve(static_cast<size_t>(n / q + 16));
  int64_t i = 0;
  while (i < n) {
    const int32_t row = rows[i];
    ChunkRef c{i, 0, 0, 0, row};
    int glo = cols[i] >> 10, ghi = glo;
    c.len = 1;
    c.glo = static_cast<int16_t>(glo);
    c.ghi = static_cast<int16_t>(ghi);
    ++i;
    while (i < n && rows[i] == row) {
      const int g = cols[i] >> 10;
      const int nlo = g < glo ? g : glo;
      const int nhi = g > ghi ? g : ghi;
      if (c.len >= q || nhi - nlo >= GL) {
        chunks.push_back(c);
        c = ChunkRef{i, 0, 0, 0, row};
        glo = ghi = g;
      } else {
        glo = nlo;
        ghi = nhi;
      }
      c.glo = static_cast<int16_t>(glo);
      c.ghi = static_cast<int16_t>(ghi);
      c.len++;
      ++i;
    }
    chunks.push_back(c);
  }

  // pass 2: counting-sort chunks by (row slab, min group) — stable, so
  // positions stay row-major within each (slab, group).  slab_rows < 0
  // keeps pure row-major order (the fused layout: steps must cover
  // contiguous row ranges so the in-kernel finish stays local).
  std::vector<size_t> order(chunks.size());
  {
    auto key_of = [&](const ChunkRef& c) -> size_t {
      if (slab_rows < 0) return 0;
      size_t slab = slab_rows > 0
                        ? static_cast<size_t>(c.row / slab_rows)
                        : 0;
      return slab * static_cast<size_t>(G) + c.glo;
    };
    size_t n_keys = 1;
    for (const ChunkRef& c : chunks) {
      size_t k = key_of(c) + 1;
      if (k + 1 > n_keys) n_keys = k + 1;
    }
    std::vector<size_t> cnt(n_keys, 0);
    for (const ChunkRef& c : chunks) cnt[key_of(c) + 1]++;
    for (size_t g = 0; g + 1 < n_keys; ++g) cnt[g + 1] += cnt[g];
    for (size_t k = 0; k < chunks.size(); ++k)
      order[cnt[key_of(chunks[k])]++] = k;
  }

  // pass 3: first-fit with group-span + residue-matching constraints
  auto* st = new PackV2State();
  std::vector<Tile*> open;
  std::vector<ChunkRef*> pending;
  long long tile_counter = 0;
  ChunkMatcher m;
  m.q = q;
  auto push_done = [&](Tile* t) {
    st->done.push_back(t);
    int b = t->glo;
    if (b > G - GL) b = G - GL;
    if (b < 0) b = 0;
    st->base.push_back(b);
  };
  auto retire = [&](size_t keep) {
    while (!open.empty() &&
           (open.front()->n_chunks >= cap || open.size() > keep)) {
      Tile* t = open.front();
      push_done(t);
      open.erase(open.begin());
    }
  };
  long long last_slab = -1;
  for (size_t k = 0; k < chunks.size(); ++k) {
    const ChunkRef& c = chunks[order[k]];
    // at sub-slab boundaries, retire tiles that are already nearly
    // full: tiles kept open across sub-slabs spread their rows into
    // later grid steps, inflating the fused finish (stage-1 tile count
    // tracks rows-touched-per-step); the < 90% ones stay open for fill
    if (slab_rows > 0) {
      const long long sk = c.row / slab_rows;
      if (sk != last_slab) {
        last_slab = sk;
        // row-keyed mode: retire EVERYTHING — a tile kept open across
        // bands collects rows from several grid steps, and the stage-1
        // finish pays a full lane column per row TOUCHED per step (the
        // measured fill gain of cross-band tiles, ~0.10, costs ~2x the
        // stage-1 slot count)
        if (lane_mode >= 2) retire(0);
        for (size_t t = 0; lane_mode < 2 && t < open.size();) {
          if (open[t]->n_chunks >= cap * 9 / 10) {
            Tile* tt = open[t];
            push_done(tt);
            open.erase(open.begin() + t);
          } else {
            ++t;
          }
        }
      }
    }
    m.n_real = c.len;
    for (int e = 0; e < c.len; ++e) {
      m.res[e] = cols[c.start + e] & (kLanes - 1);
      m.stripe[e] = cols[c.start + e] >> 7;
    }
    // row-keyed modes (lane_mode >= 2): K = 2^(lane_mode-2) candidate
    // lanes per row, evenly spaced from row & 127.  K=1 pins a row's
    // chunks to one lane (tightest stage-1 columns, starves the forward
    // matcher); larger K trades stage-1 cell spread for forward fill.
    const int n_keys = lane_mode >= 2 ? (1 << (lane_mode - 2)) : 1;
    const int key0 = c.row & (kLanes - 1);
    const int key_step = kLanes / n_keys;
    auto free_keyed_lane = [&](Tile* t, int p) -> int {
      for (int j = 0; j < n_keys; ++j) {
        const int l = (key0 + j * key_step) & (kLanes - 1);
        if (t->chunk_row[p][l] == trap_row) return l;
      }
      return -1;
    };
    bool placed = false;
    for (Tile* t : open) {
      if (t->n_chunks >= cap) continue;
      const int nlo = c.glo < t->glo ? c.glo : t->glo;
      const int nhi = c.ghi > t->ghi ? c.ghi : t->ghi;
      if (nhi - nlo >= GL) continue;
      for (int p = 0; p < planes && !placed; ++p) {
        if (t->plane_cnt[p] >= kLanes) continue;
        int lane;
        if (lane_mode >= 2) {
          lane = free_keyed_lane(t, p);
          if (lane < 0) continue;
        } else {
          const int k = t->plane_cnt[p];
          lane = lane_mode == 1
                     ? ((k * 37 + t->lane_seed) & (kLanes - 1))
                     : k;
        }
        if (m.match(t, p)) {
          place_chunk_v2(t, m, p, lane, cols, vals, c);
          t->plane_cnt[p]++;
          t->n_chunks++;
          placed = true;
        }
      }
      if (placed) break;
    }
    if (!placed) {
      Tile* t = new Tile();
      t->init(trap_row);
      t->lane_seed = static_cast<int>((tile_counter++) * 53 + 11) &
                     (kLanes - 1);
      (void)m.match(t, 0);
      const int lane0 =
          lane_mode >= 2 ? key0
          : (lane_mode == 1 ? ((0 * 37 + t->lane_seed) & (kLanes - 1))
                            : 0);
      place_chunk_v2(t, m, 0, lane0, cols, vals, c);
      t->plane_cnt[0]++;
      t->n_chunks++;
      open.push_back(t);
    }
    retire(static_cast<size_t>(max_open));
  }
  retire(0);
  *out_handle = st;
  return static_cast<long long>(st->done.size());
}

// Copy out v2 tiles.  cells are emitted RELATIVE to the tile base;
// tile_base is (n_tiles,) int32 group offsets.
void stpu_pack_copy_v2(void* handle, int q, float* values, int16_t* cells,
                       int16_t* route, int32_t* chunk_row,
                       int32_t* tile_base) {
  auto* st = static_cast<PackV2State*>(handle);
  const int planes = kChunk / q;
  size_t ti = 0;
  for (Tile* t : st->done) {
    const int base_stripe = st->base[ti] * (1024 >> 7);  // groups -> stripes
    float* v = values + ti * kChunk * kLanes;
    int16_t* ce = cells + ti * kChunk * kLanes;
    int16_t* ro = route + ti * kChunk * kLanes;
    for (int s = 0; s < kChunk; ++s) {
      std::memcpy(v + s * kLanes, t->vals[s], sizeof(float) * kLanes);
      std::memcpy(ro + s * kLanes, t->route[s], sizeof(int16_t) * kLanes);
      for (int r = 0; r < kLanes; ++r) {
        const int32_t c = t->cell[s][r];
        ce[s * kLanes + r] =
            c < 0 ? 0 : static_cast<int16_t>(c - base_stripe);
      }
    }
    for (int p = 0; p < planes; ++p)
      std::memcpy(chunk_row + (ti * planes + p) * kLanes, t->chunk_row[p],
                  sizeof(int32_t) * kLanes);
    tile_base[ti] = st->base[ti];
    ++ti;
  }
}

void stpu_pack_v2_free(void* handle) {
  delete static_cast<PackV2State*>(handle);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fused-layout finish builder (pack/fused.py fast path), two stages.
//
// Stage 1 collapses each out row's children (chunk sums at scratch
// cells (sub, lane)) into one partial per <=8 children: gather tiles
// over the step scratch, one chunk (= one row's children group) per
// (tile, lane), slots matched by the same augmenting-path residue rule
// as the forward pack.  Tile t1's per-lane slot sums land in
// scratch2[t1, :].
//
// Stage 2 maps partials to the output block with ALIGNED tiles: tile k
// covers out tiles [8g, 8g+8): position (s, l) IS out row
// (8g+s)*128 + l, gathered from scratch2 at the partial's (t1, lane1).
// The kernel then accumulates each stage-2 tile with ONE (8,128)
// dynamic-offset add — per-element scatters never happen (measured:
// 328 sub-tile RMWs/step ran 10x slower than the whole forward pass).
// ---------------------------------------------------------------------------

namespace {

struct F1Tile {
  int32_t cell[kChunk][kLanes];   // -1 free; claims scratch sublanes
  int16_t route[kChunk][kLanes];
  uint8_t used[kChunk][kLanes];
  int32_t lane_row[kLanes];       // row owning each out lane (-1 free)
  int n_chunks = 0;
  int lane_seed = 0;

  F1Tile() {
    std::memset(cell, 0xff, sizeof(cell));
    std::memset(route, 0, sizeof(route));
    std::memset(used, 0, sizeof(used));
    std::memset(lane_row, 0xff, sizeof(lane_row));
  }
};

struct F2Tile {
  int32_t group;                  // out tiles [8*group, 8*group+8)
  int32_t cell[kChunk][kLanes];   // -1 free; claims scratch2 sublanes
  int16_t route[kChunk][kLanes];
  uint8_t used[kChunk][kLanes];

  explicit F2Tile(int32_t g) : group(g) {
    std::memset(cell, 0xff, sizeof(cell));
    std::memset(route, 0, sizeof(route));
    std::memset(used, 0, sizeof(used));
  }
};

struct FinMatcher {
  int n_real;
  int res[kChunk];
  int32_t stripe[kChunk];
  int slot_of[kChunk];
  int elem_of[kChunk];
  bool visited[kChunk];
  const int32_t (*cells)[kLanes];

  bool candidate(int e, int s) const {
    int32_t c = cells[s][res[e]];
    return c == -1 || c == stripe[e];
  }
  bool augment(int e) {
    for (int s = 0; s < kChunk; ++s) {
      if (!candidate(e, s) || visited[s]) continue;
      visited[s] = true;
      if (elem_of[s] < 0 || augment(elem_of[s])) {
        elem_of[s] = e;
        slot_of[e] = s;
        return true;
      }
    }
    return false;
  }
  bool match(const int32_t (*c)[kLanes]) {
    cells = c;
    for (int i = 0; i < kChunk; ++i) {
      slot_of[i] = -1;
      elem_of[i] = -1;
    }
    for (int e = 0; e < n_real; ++e) {
      for (int s = 0; s < kChunk; ++s) visited[s] = false;
      if (!augment(e)) return false;
    }
    return true;
  }

  // place as many elements as possible; returns the matched count (the
  // matched prefix keeps slot_of valid for elements [0, count))
  int match_partial(const int32_t (*c)[kLanes]) {
    cells = c;
    for (int i = 0; i < kChunk; ++i) {
      slot_of[i] = -1;
      elem_of[i] = -1;
    }
    int got = 0;
    for (int e = 0; e < n_real; ++e) {
      for (int s = 0; s < kChunk; ++s) visited[s] = false;
      if (!augment(e)) break;
      ++got;
    }
    return got;
  }
};

struct FinState {
  std::vector<F1Tile*> t1;
  std::vector<F2Tile*> t2;
  ~FinState() {
    for (F1Tile* t : t1) delete t;
    for (F2Tile* t : t2) delete t;
  }
};

}  // namespace

extern "C" {

// Children must arrive sorted by orow.  max_f1 bounds the stage-1 tile
// count (the kernel's scratch2 height).  ``direct`` skips stage 1 and
// feeds children straight into stage-2 tiles (cell = the child's
// scratch sublane) — the scattered regime, where rows have 1-3 children
// and stage 1's one-group-per-lane shape would waste ~70% of its tiles.
// ``l1_keys`` picks the stage-1 OUT-lane rule: 0 = per-tile 37-stride
// shuffle (legacy), K >= 1 = row-keyed — lane one of the K values
// (row + j*128/K) & 127.  Row-keyed lanes make stage 2 near-conflict-
// free: the partial's scratch2 lane then EQUALS (for K=1) the row's out
// lane, so a stage-2 tile's cell[s][res] is claimed exactly once per
// out position and F2 collapses to ~groups-touched (measured 10 -> ~3
// per step on the banded headline; the 37-stride lanes collided).
// Returns (n_t1 << 32) | n_t2, or -1 if stage 1 overflows max_f1.
long long stpu_fused_finish(const int32_t* orow, const int32_t* sub,
                            const int32_t* lane, long long n, int max_f1,
                            int direct, int l1_keys, void** out_handle) {
  auto* st = new FinState();
  FinMatcher m;
  long long i = 0;
  // ---- stage 1: per-row chunks into gather tiles
  // partial list: (orow, t1, lane1) per chunk
  std::vector<int32_t> p_row, p_t1, p_lane;
  if (direct) {
    p_row.reserve(n);
    p_t1.reserve(n);
    p_lane.reserve(n);
    for (long long k = 0; k < n; ++k) {
      p_row.push_back(orow[k]);
      p_t1.push_back(sub[k]);
      p_lane.push_back(lane[k]);
    }
    i = n;
  }
  while (i < n) {
    const int32_t r = orow[i];
    m.n_real = 0;
    while (i < n && orow[i] == r && m.n_real < kChunk) {
      m.res[m.n_real] = static_cast<int>(lane[i]);
      m.stripe[m.n_real] = sub[i];
      ++m.n_real;
      ++i;
    }
    F1Tile* dst = nullptr;
    int l_keyed = -1;
    const int key0 = static_cast<int>(r) & (kLanes - 1);
    const int key_step = l1_keys > 0 ? kLanes / l1_keys : 0;
    for (F1Tile* t : st->t1) {
      if (t->n_chunks >= kLanes) continue;
      if (l1_keys > 0) {
        int lf = -1;
        for (int j = 0; j < l1_keys; ++j) {
          const int lc = (key0 + j * key_step) & (kLanes - 1);
          if (t->lane_row[lc] == -1) {
            lf = lc;
            break;
          }
        }
        if (lf < 0) continue;
        l_keyed = lf;
      }
      if (m.match(t->cell)) {
        dst = t;
        break;
      }
    }
    if (!dst) {
      if (static_cast<int>(st->t1.size()) >= max_f1) {
        delete st;
        return -1;
      }
      dst = new F1Tile();
      dst->lane_seed =
          static_cast<int>(st->t1.size() * 53 + 29) & (kLanes - 1);
      st->t1.push_back(dst);
      (void)m.match(dst->cell);
      l_keyed = key0;
    }
    const int k = dst->n_chunks++;
    const int l = l1_keys > 0 ? l_keyed
                              : ((k * 37 + dst->lane_seed) & (kLanes - 1));
    dst->lane_row[l] = r;
    for (int e = 0; e < m.n_real; ++e) {
      const int s = m.slot_of[e];
      dst->cell[s][m.res[e]] = m.stripe[e];
      dst->route[s][l] = static_cast<int16_t>(m.res[e]);
      dst->used[s][l] = 1;
    }
    int32_t t1_idx = 0;
    for (size_t k2 = 0; k2 < st->t1.size(); ++k2)
      if (st->t1[k2] == dst) t1_idx = static_cast<int32_t>(k2);
    p_row.push_back(r);
    p_t1.push_back(t1_idx);
    p_lane.push_back(l);
  }
  // ---- stage 2: aligned-group tiles over scratch2
  // partials are in orow order (stage 1 preserved it)
  for (size_t k = 0; k < p_row.size(); ++k) {
    const int32_t r = p_row[k];
    const int32_t g = r / (kChunk * kLanes);
    const int s = static_cast<int>((r / kLanes) % kChunk);
    const int l = static_cast<int>(r % kLanes);
    const int res = static_cast<int>(p_lane[k]);
    const int32_t stripe = p_t1[k];
    F2Tile* dst = nullptr;
    for (F2Tile* t : st->t2) {
      if (t->group != g || t->used[s][l]) continue;
      int32_t c = t->cell[s][res];
      if (c != -1 && c != stripe) continue;
      dst = t;
      break;
    }
    if (!dst) {
      dst = new F2Tile(g);
      st->t2.push_back(dst);
    }
    dst->cell[s][res] = stripe;
    dst->route[s][l] = static_cast<int16_t>(res);
    dst->used[s][l] = 1;
  }
  *out_handle = st;
  return (static_cast<long long>(st->t1.size()) << 32) |
         static_cast<long long>(st->t2.size());
}

// cells drains: stage 1 -> scr_rows (the step scratch height); stage 2
// -> f1_drain (the scratch2 height).
void stpu_fused_finish_copy(void* handle, int scr_rows, int f1_drain,
                            int16_t* cells1, int8_t* route1,
                            int32_t* group2, int16_t* cells2,
                            int8_t* route2) {
  auto* st = static_cast<FinState*>(handle);
  size_t ti = 0;
  for (F1Tile* t : st->t1) {
    int16_t* ce = cells1 + ti * kChunk * kLanes;
    int8_t* ro = route1 + ti * kChunk * kLanes;
    for (int s = 0; s < kChunk; ++s) {
      int free_r = 0;
      while (free_r < kLanes - 1 && t->cell[s][free_r] != -1) ++free_r;
      for (int r = 0; r < kLanes; ++r) {
        const int32_t c = t->cell[s][r];
        ce[s * kLanes + r] =
            c < 0 ? static_cast<int16_t>(scr_rows)
                  : static_cast<int16_t>(c);
      }
      for (int l = 0; l < kLanes; ++l)
        ro[s * kLanes + l] = t->used[s][l]
                                 ? static_cast<int8_t>(t->route[s][l])
                                 : static_cast<int8_t>(free_r);
    }
    ++ti;
  }
  ti = 0;
  for (F2Tile* t : st->t2) {
    group2[ti] = t->group;
    int16_t* ce = cells2 + ti * kChunk * kLanes;
    int8_t* ro = route2 + ti * kChunk * kLanes;
    for (int s = 0; s < kChunk; ++s) {
      int free_r = 0;
      while (free_r < kLanes - 1 && t->cell[s][free_r] != -1) ++free_r;
      for (int r = 0; r < kLanes; ++r) {
        const int32_t c = t->cell[s][r];
        ce[s * kLanes + r] =
            c < 0 ? static_cast<int16_t>(f1_drain)
                  : static_cast<int16_t>(c);
      }
      for (int l = 0; l < kLanes; ++l)
        ro[s * kLanes + l] = t->used[s][l]
                                 ? static_cast<int8_t>(t->route[s][l])
                                 : static_cast<int8_t>(free_r);
    }
    ++ti;
  }
}

void stpu_fused_finish_free(void* handle) {
  delete static_cast<FinState*>(handle);
}

}  // extern "C"
