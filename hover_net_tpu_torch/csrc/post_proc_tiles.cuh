// Tile geometry and the per-tile steps of K1's connected components and
// watershed sweeps (post_proc_tail.cu; K2 and K4 share them). Free of
// CUDA headers, so that it also compiles as plain C++ (g++): the serial
// harness of tests/test_torch_pp_tiles.py runs a kernel's blocks and
// threads as loops over these same functions, one valid interleaving of
// the kernel, and holds the result against the plain PyTorch version.
//
// A tile is kTileH x kTileW pixels of one map of the batch (the last
// row and column of tiles may be cut by the map's edge); tiles never
// span two maps. One block of kTileThreads threads works one tile; in
// the watershed thread `tid` owns the kPxPerThread pixels
// lane_pixel(tid, k, order) and keeps their state in registers (a
// Lane), while the tile and a 1-pixel halo of costs (and labels) live in
// shared memory.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define PPT_HD __host__ __device__ __forceinline__
#define PPT_UNROLL _Pragma("unroll")
#else
#define PPT_HD inline
#define PPT_UNROLL
#endif

namespace ppt {

constexpr int kTileW = 32;
constexpr int kTileH = 32;
constexpr int kTilePx = kTileW * kTileH;
constexpr int kTileThreads = 256;
constexpr int kPxPerThread = kTilePx / kTileThreads;
constexpr int kHaloW = kTileW + 2;
constexpr int kHaloPx = kHaloW * (kTileH + 2);
constexpr int kBorderPairs = kTileW + kTileH;  // a tile's upper + left edge
constexpr int kIntMax = 0x7fffffff;
constexpr int kHopBits = 15;
constexpr int kHopMask = (1 << kHopBits) - 1;
constexpr int64_t kStride = 7919;  // prime; sweep order 2
// phase 2's word of a pixel no marker has reached: hops INT_MAX, label 0
constexpr unsigned long long kUnreached = (unsigned long long)kIntMax << 32;

PPT_HD int imin(int a, int b) { return a < b ? a : b; }

// atomicMin on the card; the serial harness has one thread at a time
PPT_HD int atomic_min(int* p, int v) {
#ifdef __CUDA_ARCH__
  return atomicMin(p, v);
#else
  int old = *p;
  if (v < old) *p = v;
  return old;
#endif
}

// The t-th index of a sweep over `count` items: 0 forward, 1 reversed,
// 2 strided by a prime (a permutation unless count % kStride == 0).
PPT_HD int64_t sweep_index(int64_t t, int64_t count, int order) {
  if (order == 1) return count - 1 - t;
  if (order == 2) return (t * kStride) % count;
  return t;
}

// ------------------------------------------------------------ geometry

struct TileGrid {
  int h, w, tiles_y, tiles_x;
  int64_t hw, tiles;  // pixels of one map; tiles of the whole batch
};

PPT_HD TileGrid tile_grid(int n, int h, int w) {
  TileGrid g;
  g.h = h;
  g.w = w;
  g.tiles_y = (h + kTileH - 1) / kTileH;
  g.tiles_x = (w + kTileW - 1) / kTileW;
  g.hw = (int64_t)h * w;
  g.tiles = (int64_t)n * g.tiles_y * g.tiles_x;
  return g;
}

struct Tile {
  int64_t base;    // linear index of its map's first pixel
  int y0, x0;      // its first pixel in the map
  int th, tw;      // rows and columns inside the map
};

PPT_HD Tile tile_at(const TileGrid& g, int64_t b) {
  int64_t per = (int64_t)g.tiles_y * g.tiles_x;
  int64_t img = b / per, r = b - img * per;
  int ty = (int)(r / g.tiles_x), tx = (int)(r - (int64_t)ty * g.tiles_x);
  Tile t;
  t.base = img * g.hw;
  t.y0 = ty * kTileH;
  t.x0 = tx * kTileW;
  t.th = imin(kTileH, g.h - t.y0);
  t.tw = imin(kTileW, g.w - t.x0);
  return t;
}

// the linear index of local pixel l = row * kTileW + col
PPT_HD int64_t tile_index(const Tile& t, const TileGrid& g, int l) {
  int r = l / kTileW;
  return t.base + (int64_t)(t.y0 + r) * g.w + t.x0 + (l - r * kTileW);
}

// its linear index into *gi; false if it lies beyond the map
PPT_HD bool tile_pixel(const Tile& t, const TileGrid& g, int l, int64_t* gi) {
  int r = l / kTileW;
  if (r >= t.th || l - r * kTileW >= t.tw) return false;
  *gi = tile_index(t, g, l);
  return true;
}

// the halo array's index of local pixel l
PPT_HD int halo_of(int l) {
  int r = l / kTileW;
  return (r + 1) * kHaloW + (l - r * kTileW) + 1;
}

// the map pixel under halo index hl, false beyond the map's edge
PPT_HD bool halo_pixel(const Tile& t, const TileGrid& g, int hl, int64_t* gi) {
  int r = hl / kHaloW;
  int y = t.y0 + r - 1, x = t.x0 + (hl - r * kHaloW) - 1;
  if (y < 0 || y >= g.h || x < 0 || x >= g.w) return false;
  *gi = t.base + (int64_t)y * g.w + x;
  return true;
}

// ----------------------------------------------------------------- CCL
// Block-based union-find. Every root is the least index of its set:
// within a tile the local raster order is the map's raster order, so a
// local root's global index is still its component's least index in the
// tile, and the border merge links larger roots under smaller ones.

PPT_HD bool in_mask(const uint8_t* mask, int pol, int64_t i) {
  return (mask[i] != 0) == (pol != 0);
}

PPT_HD int find_root(const int* parent, int x) {
  const volatile int* p = parent;
  int nx = p[x];
  while (nx != x) {
    x = nx;
    nx = p[x];
  }
  return x;
}

// path halving: each node on the way is relinked to its grandparent by
// atomic_min, so a parent only ever falls and stays inside its set
PPT_HD int find_compress(int* parent, int x) {
  const volatile int* p = parent;
  for (;;) {
    int px = p[x];
    if (px == x) return x;
    int gp = p[px];
    if (gp == px) return px;
    atomic_min(&parent[x], gp);
    x = gp;
  }
}

// link the roots of a and b, the larger under the smaller
template <bool kCompress>
PPT_HD void unite(int* parent, int a, int b) {
  for (;;) {
    a = kCompress ? find_compress(parent, a) : find_root(parent, a);
    b = kCompress ? find_compress(parent, b) : find_root(parent, b);
    if (a == b) return;
    if (a > b) {
      int t = a;
      a = b;
      b = t;
    }
    int old = atomic_min(&parent[b], a);
    if (old == b) return;  // b was a root and now hangs below a
    b = old;               // b had been relinked: unite a with that
  }
}

// count of leading zero bits
PPT_HD int clz32(unsigned x) {
#ifdef __CUDA_ARCH__
  return __clz(x);
#else
  return x ? __builtin_clz(x) : 32;
#endif
}

// The local pass works on runs: a row's pixels of the mask that follow
// each other without a gap share one root from the start, the run's
// first pixel, and unions are only made between rows.

// Local pass, step 1 (pixel l): whether it lies in the map and in the
// mask; `rows[r]` gathers row r's answers as bits (bit c: column c), on
// the card with one warp ballot a row (kTileW is the warp's width).
PPT_HD bool ccl_pixel_in(const Tile& t, const TileGrid& g,
                         const uint8_t* mask, int pol, int l) {
  int64_t gi;
  return tile_pixel(t, g, l, &gi) && in_mask(mask, pol, gi);
}

// the first column of the run that holds column c of a row
PPT_HD int run_start(unsigned bits, int c) {
  unsigned gaps = ~bits & ((1u << c) - 1u);
  return gaps ? 32 - clz32(gaps) : 0;
}

// Step 2 (pixel l): its shared parent is its run's first pixel (itself
// off the mask).
PPT_HD void ccl_local_runs(const unsigned* rows, int* sp, int l) {
  int r = l / kTileW, c = l - r * kTileW;
  sp[l] = rows[r] >> c & 1u ? r * kTileW + run_start(rows[r], c) : l;
}

// Step 3 (pixel l): unite its run with the run above, once for each
// stretch of columns where both rows are in the mask (at its first
// column), in shared memory.
PPT_HD void ccl_local_unite(const unsigned* rows, int* sp, int l) {
  int r = l / kTileW, c = l - r * kTileW;
  if (r == 0) return;
  unsigned both = rows[r] & rows[r - 1];
  if ((both >> c & 1u) && (c == 0 || !(both >> (c - 1) & 1u)))
    unite<false>(sp, l, l - kTileW);
}

// Step 4 (pixel l of the mask): the global index of its local root into
// `parent` (nothing reads the parent of a pixel off the mask).
PPT_HD void ccl_local_store(const Tile& t, const TileGrid& g,
                            const unsigned* rows, const int* sp, int* parent,
                            int l) {
  int64_t gi;
  if ((rows[l / kTileW] >> (l % kTileW) & 1u) && tile_pixel(t, g, l, &gi))
    parent[gi] = (int)tile_index(t, g, find_root(sp, l));
}

// Border merge: pair k of a tile is a pixel `a` on its upper edge (k <
// kTileW) or its left edge and the pixel `b` across it; false where the
// edge is the map's or the pixel lies beyond the map.
PPT_HD bool border_pair(const Tile& t, const TileGrid& g, int k, int64_t* a,
                        int64_t* b) {
  int y, x;
  int64_t step;
  if (k < kTileW) {
    if (t.y0 == 0 || k >= t.tw) return false;
    y = t.y0;
    x = t.x0 + k;
    step = g.w;
  } else {
    k -= kTileW;
    if (t.x0 == 0 || k >= t.th) return false;
    y = t.y0 + k;
    x = t.x0;
    step = 1;
  }
  *a = t.base + (int64_t)y * g.w + x;
  *b = *a - step;
  return true;
}

// Merge pair k of tile t if both its pixels are in the mask, unless the
// pair before it on the same edge is too: that pair's pixels neighbour
// this pair's inside their own tiles, so it joins the same components.
PPT_HD void ccl_border_merge(const Tile& t, const TileGrid& g,
                             const uint8_t* mask, int pol, int* parent,
                             int k) {
  int64_t a, b;
  if (!border_pair(t, g, k, &a, &b) || !in_mask(mask, pol, a) ||
      !in_mask(mask, pol, b))
    return;
  int64_t pa, pb;
  if (k % kTileW != 0 && border_pair(t, g, k - 1, &pa, &pb) &&
      in_mask(mask, pol, pa) && in_mask(mask, pol, pb))
    return;
  unite<true>(parent, (int)a, (int)b);
}


// ----------------------------------------------------------- watershed
// A sweep loads each tile with its halo, relaxes the tile to its local
// fixpoint with the halo held fixed, and writes back the pixels that
// fell. Both phases relax monotone operators, so any order of tiles and
// pixels, and any staleness of a halo, reaches the one fixpoint.

PPT_HD int cross_cost(int q_c, int energy_sh) {
  int lev = q_c & ~kHopMask;
  return energy_sh > lev ? energy_sh : q_c + ((q_c & kHopMask) != kHopMask);
}

// Whether a sweep relaxes tile b. `done` holds a byte a tile from the
// sweep before: whether the tile stored a fall (null in a phase's first
// sweep: every tile). A tile none of whose four neighbours stored a fall
// is still at its fixpoint against its halo: it relaxed against those
// values when it last ran, or its neighbours would have woken it since.
PPT_HD bool tile_active(const TileGrid& g, const uint8_t* done, int64_t b) {
  if (!done) return true;
  int64_t r = b % ((int64_t)g.tiles_y * g.tiles_x);
  int ty = (int)(r / g.tiles_x), tx = (int)(r - (int64_t)ty * g.tiles_x);
  return (tx > 0 && done[b - 1]) || (tx + 1 < g.tiles_x && done[b + 1]) ||
         (ty > 0 && done[b - g.tiles_x]) ||
         (ty + 1 < g.tiles_y && done[b + g.tiles_x]);
}

// the halo's value at hl: the map's, or `outside` beyond its edge
template <typename T>
PPT_HD T halo_value(const Tile& t, const TileGrid& g, const T* src, int hl,
                    T outside) {
  int64_t gi;
  return halo_pixel(t, g, hl, &gi) ? src[gi] : outside;
}

// Pixel k of thread tid's lane: in order 0 a warp holds one row of the
// tile (coalesced loads and stores).
PPT_HD int lane_pixel(int tid, int k, int order) {
  return (int)sweep_index(tid + k * kTileThreads, kTilePx, order);
}

// the four neighbours' offsets in the halo array
PPT_HD int halo_step(int d) {
  return d == 0 ? -1 : d == 1 ? 1 : d == 2 ? -kHaloW : kHaloW;
}

// whether thread tid owns a pixel of the mask
PPT_HD bool lane_in_mask(const Tile& t, const TileGrid& g, const uint8_t* mask,
                         int tid, int order) {
  bool any = false;
  PPT_UNROLL
  for (int k = 0; k < kPxPerThread; ++k) {
    int64_t gi;
    any |= tile_pixel(t, g, lane_pixel(tid, k, order), &gi) && mask[gi];
  }
  return any;
}

// one thread's pixels in phase 1: halo index (-1: none), shifted
// energy, cost now and as loaded
struct CostLane {
  int h[kPxPerThread], e[kPxPerThread], c[kPxPerThread], c0[kPxPerThread];
};

// the lane of thread tid: the pixels of the mask it owns; true if any
PPT_HD bool cost_lane_load(CostLane& ln, const Tile& t, const TileGrid& g,
                           const int* cost, const int* energy_sh,
                           const uint8_t* mask, int tid, int order) {
  bool any = false;
  PPT_UNROLL
  for (int k = 0; k < kPxPerThread; ++k) {
    int l = lane_pixel(tid, k, order);
    int64_t gi;
    ln.h[k] = -1;
    if (tile_pixel(t, g, l, &gi) && mask[gi]) {
      ln.h[k] = halo_of(l);
      ln.e[k] = energy_sh[gi];
      ln.c[k] = ln.c0[k] = cost[gi];
      any = true;
    }
  }
  return any;
}

// one pass over the lane against the shared costs `hc`, each fall
// written at once; true if any pixel fell
PPT_HD bool cost_lane_relax(CostLane& ln, int* hc) {
  const volatile int* v = hc;
  bool fell = false;
  PPT_UNROLL
  for (int k = 0; k < kPxPerThread; ++k) {
    int h = ln.h[k];
    if (h < 0) continue;
    int e = ln.e[k], best = ln.c[k];
    PPT_UNROLL
    for (int d = 0; d < 4; ++d) best = imin(best, cross_cost(v[h + halo_step(d)], e));
    if (best < ln.c[k]) {
      ln.c[k] = best;
      hc[h] = best;
      fell = true;
    }
  }
  return fell;
}

// the pixels that fell back to `cost`; true if any
PPT_HD bool cost_lane_store(const CostLane& ln, const Tile& t,
                            const TileGrid& g, int* cost, int tid,
                            int order) {
  bool any = false;
  PPT_UNROLL
  for (int k = 0; k < kPxPerThread; ++k) {
    if (ln.h[k] < 0 || ln.c[k] >= ln.c0[k]) continue;
    cost[tile_index(t, g, lane_pixel(tid, k, order))] = ln.c[k];
    any = true;
  }
  return any;
}

// one thread's pixels in phase 2: halo index (-1: none), the neighbours
// whose edge attains the pixel's fixed cost (bit d: halo_step(d)), the
// packed (hops << 32 | label) now and as loaded
struct LabelLane {
  int h[kPxPerThread];
  unsigned nb[kPxPerThread];
  unsigned long long v[kPxPerThread], v0[kPxPerThread];
};

// the lane of thread tid, once the halo costs `hc` are loaded: the
// reached pixels of the mask it owns; true if any
PPT_HD bool label_lane_load(LabelLane& ln, const Tile& t, const TileGrid& g,
                            const int* hc, const int* energy_sh,
                            const uint8_t* mask,
                            const unsigned long long* packed, int tid,
                            int order) {
  bool any = false;
  PPT_UNROLL
  for (int k = 0; k < kPxPerThread; ++k) {
    int l = lane_pixel(tid, k, order);
    int64_t gi;
    ln.h[k] = -1;
    if (!tile_pixel(t, g, l, &gi) || !mask[gi]) continue;
    int h = halo_of(l), c = hc[h];
    if (c == kIntMax) continue;
    int e = energy_sh[gi];
    unsigned nb = 0;
    PPT_UNROLL
    for (int d = 0; d < 4; ++d) {
      int q_c = hc[h + halo_step(d)];
      if (q_c != kIntMax && cross_cost(q_c, e) == c) nb |= 1u << d;
    }
    ln.h[k] = h;
    ln.nb[k] = nb;
    ln.v[k] = ln.v0[k] = packed[gi];
    any = true;
  }
  return any;
}

// one pass over the lane against the shared words `hv`: the least offer
// (neighbour's hops + 1, its label) of a reached neighbour along an
// attaining edge, each fall written at once; true if any pixel fell
PPT_HD bool label_lane_relax(LabelLane& ln, unsigned long long* hv) {
  const volatile unsigned long long* pv = hv;
  bool fell = false;
  PPT_UNROLL
  for (int k = 0; k < kPxPerThread; ++k) {
    int h = ln.h[k];
    if (h < 0) continue;
    unsigned long long best = ln.v[k];
    PPT_UNROLL
    for (int d = 0; d < 4; ++d) {
      if (!(ln.nb[k] >> d & 1u)) continue;
      unsigned long long q = pv[h + halo_step(d)];
      if ((unsigned)q == 0u || (q >> 32) == (unsigned long long)kIntMax)
        continue;
      q += 1ull << 32;
      if (q < best) best = q;
    }
    if (best < ln.v[k]) {
      ln.v[k] = best;
      hv[h] = best;
      fell = true;
    }
  }
  return fell;
}

PPT_HD bool label_lane_store(const LabelLane& ln, const Tile& t,
                             const TileGrid& g, unsigned long long* packed,
                             int tid, int order) {
  bool any = false;
  PPT_UNROLL
  for (int k = 0; k < kPxPerThread; ++k) {
    if (ln.h[k] < 0 || ln.v[k] >= ln.v0[k]) continue;
    packed[tile_index(t, g, lane_pixel(tid, k, order))] = ln.v[k];
    any = true;
  }
  return any;
}

}  // namespace ppt
