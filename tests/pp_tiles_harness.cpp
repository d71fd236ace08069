// Serial host harness of hover_net_tpu_torch/csrc/post_proc_tiles.cuh.
//
// Each tiled kernel of post_proc_tail.cu (ccl_local, ccl_border,
// ccl_roots, ws_cost_tiles, ws_label_tiles) runs here with its blocks and
// threads as loops over the header's own steps, in the kernel's order of
// steps and barriers: one valid interleaving of what the card runs.
// `mode` picks the interleaving: 0 runs the blocks one after another, in
// the sweep order; 1 runs the CCL's blocks and border pairs backwards,
// and starts every block of a watershed sweep (its tile and halo loaded)
// before any block relaxes or stores, as if all ran at once.
//
// Built by tests/test_torch_pp_tiles.py with g++ into a shared library:
//   g++ -std=c++17 -O2 -shared -fPIC -I hover_net_tpu_torch/csrc
//       -o pp_tiles.so tests/pp_tiles_harness.cpp
// Plain C interface, for ctypes.

#include <stdint.h>

#include <vector>

#include "post_proc_tiles.cuh"

using namespace ppt;

namespace {

// ccl_local, ccl_border and ccl_roots (whose warps walk each shared
// chain once; here every pixel walks its own, which gives the same roots)
void ccl(const uint8_t* mask, int pol, int* parent, int n, int h, int w,
         int mode) {
  TileGrid g = tile_grid(n, h, w);
  std::vector<int> sp(kTilePx);
  std::vector<unsigned> rows(kTileH);
  for (int64_t bb = 0; bb < g.tiles; ++bb) {
    Tile t = tile_at(g, mode ? g.tiles - 1 - bb : bb);
    for (int r = 0; r < kTileH; ++r) {  // the kernel's ballot of row r
      rows[r] = 0;
      for (int c = 0; c < kTileW; ++c)
        rows[r] |= (unsigned)ccl_pixel_in(t, g, mask, pol, r * kTileW + c) << c;
    }
    for (int l = 0; l < kTilePx; ++l) ccl_local_runs(rows.data(), sp.data(), l);
    for (int ll = 0; ll < kTilePx; ++ll)
      ccl_local_unite(rows.data(), sp.data(), mode ? kTilePx - 1 - ll : ll);
    for (int l = 0; l < kTilePx; ++l)
      ccl_local_store(t, g, rows.data(), sp.data(), parent, l);
  }
  for (int64_t bb = 0; bb < g.tiles; ++bb) {
    Tile t = tile_at(g, mode ? g.tiles - 1 - bb : bb);
    for (int kk = 0; kk < kBorderPairs; ++kk)
      ccl_border_merge(t, g, mask, pol, parent,
                       mode ? kBorderPairs - 1 - kk : kk);
  }
  for (int64_t i = 0; i < (int64_t)n * g.hw; ++i)  // ccl_roots
    if (in_mask(mask, pol, i)) parent[i] = find_root(parent, parent[i]);
}

template <typename Lane>
struct Block {
  int64_t b;
  Tile t;
  bool live = false;
  std::vector<Lane> lanes;
  std::vector<int> hc;
  std::vector<unsigned long long> hv;
};

// one sweep of ws_cost_tiles; true if a pixel fell
bool cost_sweep(int* cost, const int* esh, const uint8_t* mask,
                const TileGrid& g, int order, const uint8_t* done,
                uint8_t* mark, int mode) {
  std::vector<Block<CostLane>> blocks(mode ? g.tiles : 1);
  auto start = [&](Block<CostLane>& B, int64_t bi) {
    B.b = sweep_index(bi, g.tiles, order);
    B.t = tile_at(g, B.b);
    B.lanes.assign(kTileThreads, CostLane());
    B.live = false;
    if (tile_active(g, done, B.b))
      for (int tid = 0; tid < kTileThreads; ++tid)
        B.live |= cost_lane_load(B.lanes[tid], B.t, g, cost, esh, mask, tid,
                                 order);
    mark[B.b] = 0;
    if (!B.live) return;
    B.hc.resize(kHaloPx);
    for (int hl = 0; hl < kHaloPx; ++hl)
      B.hc[hl] = halo_value(B.t, g, (const int*)cost, hl, kIntMax);
  };
  auto finish = [&](Block<CostLane>& B) {
    if (!B.live) return false;
    for (bool fell = true; fell;) {
      fell = false;
      for (int tid = 0; tid < kTileThreads; ++tid)
        fell |= cost_lane_relax(B.lanes[tid], B.hc.data());
    }
    bool stored = false;
    for (int tid = 0; tid < kTileThreads; ++tid)
      stored |= cost_lane_store(B.lanes[tid], B.t, g, cost, tid, order);
    mark[B.b] = stored;
    return stored;
  };
  bool changed = false;
  for (int64_t bi = 0; bi < g.tiles; ++bi) {
    start(blocks[mode ? bi : 0], bi);
    if (!mode) changed |= finish(blocks[0]);
  }
  if (mode)
    for (auto& B : blocks) changed |= finish(B);
  return changed;
}

// one sweep of ws_label_tiles; true if a pixel fell
bool label_sweep(const int* cost, const int* esh, const uint8_t* mask,
                 unsigned long long* packed, const TileGrid& g, int order,
                 const uint8_t* done, uint8_t* mark, int mode) {
  std::vector<Block<LabelLane>> blocks(mode ? g.tiles : 1);
  auto start = [&](Block<LabelLane>& B, int64_t bi) {
    B.b = sweep_index(bi, g.tiles, order);
    B.t = tile_at(g, B.b);
    B.live = false;
    mark[B.b] = 0;
    if (tile_active(g, done, B.b))
      for (int tid = 0; tid < kTileThreads; ++tid)
        B.live |= lane_in_mask(B.t, g, mask, tid, order);
    if (!B.live) return;
    B.hc.resize(kHaloPx);
    B.hv.resize(kHaloPx);
    for (int hl = 0; hl < kHaloPx; ++hl) {
      B.hc[hl] = halo_value(B.t, g, cost, hl, kIntMax);
      B.hv[hl] = halo_value(B.t, g, (const unsigned long long*)packed, hl,
                            kUnreached);
    }
    B.lanes.assign(kTileThreads, LabelLane());
    B.live = false;
    for (int tid = 0; tid < kTileThreads; ++tid)
      B.live |= label_lane_load(B.lanes[tid], B.t, g, B.hc.data(), esh, mask,
                                packed, tid, order);
  };
  auto finish = [&](Block<LabelLane>& B) {
    if (!B.live) return false;
    for (bool fell = true; fell;) {
      fell = false;
      for (int tid = 0; tid < kTileThreads; ++tid)
        fell |= label_lane_relax(B.lanes[tid], B.hv.data());
    }
    bool stored = false;
    for (int tid = 0; tid < kTileThreads; ++tid)
      stored |= label_lane_store(B.lanes[tid], B.t, g, packed, tid, order);
    mark[B.b] = stored;
    return stored;
  };
  bool changed = false;
  for (int64_t bi = 0; bi < g.tiles; ++bi) {
    start(blocks[mode ? bi : 0], bi);
    if (!mode) changed |= finish(blocks[0]);
  }
  if (mode)
    for (auto& B : blocks) changed |= finish(B);
  return changed;
}

}  // namespace

extern "C" {

// labels: 1 + the least index of the pixel's component in its map, 0 off
// the mask (pol 1: mask set, 0: clear)
void ppt_ccl(const uint8_t* mask, int pol, int n, int h, int w, int mode,
             int* labels) {
  int64_t hw = (int64_t)h * w, total = n * hw;
  std::vector<int> parent(total);
  ccl(mask, pol, parent.data(), n, h, w, mode);
  for (int64_t i = 0; i < total; ++i)
    labels[i] = in_mask(mask, pol, i) ? (int)(parent[i] - i / hw * hw + 1) : 0;
}

// K1's fill-holes on the tiled CCL: the CCL of the background, then
// border_touch and fill_enclosed of post_proc_tail.cu
void ppt_fill_holes(const uint8_t* marker, int n, int h, int w, int mode,
                    uint8_t* out) {
  int64_t hw = (int64_t)h * w, total = n * hw;
  std::vector<int> parent(total), touch(total, 0);
  ccl(marker, 0, parent.data(), n, h, w, mode);
  for (int64_t i = 0; i < total; ++i) {
    int64_t p = i % hw;
    int y = (int)(p / w), x = (int)(p % w);
    if (!marker[i] && (y == 0 || y == h - 1 || x == 0 || x == w - 1))
      touch[parent[i]] = 1;
  }
  for (int64_t i = 0; i < total; ++i)
    out[i] = marker[i] || !touch[parent[i]];
}

// K2 on the tiled sweeps: ws_seed, phase 1 and phase 2 each to the first
// sweep that changes nothing, ws_final; sweeps[2] receives the sweep
// counts; returns -1 if a phase exceeds the kernel's bound of sweeps
int ppt_watershed(const int* energy_q, const int* markers,
                  const uint8_t* mask, int n, int h, int w, int order,
                  int mode, int* out, int64_t* sweeps) {
  TileGrid g = tile_grid(n, h, w);
  int64_t total = n * g.hw;
  std::vector<int> esh(total), cost(total);
  std::vector<unsigned long long> packed(total);
  for (int64_t i = 0; i < total; ++i) {
    bool seeded = markers[i] > 0 && mask[i];
    esh[i] = (int)((unsigned)energy_q[i] << kHopBits);
    cost[i] = seeded ? esh[i] : kIntMax;
    packed[i] = seeded ? (unsigned long long)(unsigned)markers[i] : kUnreached;
  }
  // sweep j of a phase reads the tiles' stores of sweep j - 1 from one
  // half and writes its own into the other (relax in post_proc_tail.cu)
  std::vector<uint8_t> tile_flags(2 * g.tiles);
  auto done = [&](int64_t j) {
    return j ? tile_flags.data() + ((j - 1) & 1) * g.tiles : nullptr;
  };
  auto mark = [&](int64_t j) { return tile_flags.data() + (j & 1) * g.tiles; };
  sweeps[0] = sweeps[1] = 0;
  for (int64_t j = 0;; ++j) {
    if (++sweeps[0] > total + 1) return -1;
    if (!cost_sweep(cost.data(), esh.data(), mask, g, order, done(j), mark(j),
                    mode))
      break;
  }
  for (int64_t j = 0;; ++j) {
    if (++sweeps[1] > total + 1) return -1;
    if (!label_sweep(cost.data(), esh.data(), mask, packed.data(), g, order,
                     done(j), mark(j), mode))
      break;
  }
  for (int64_t i = 0; i < total; ++i)
    out[i] = mask[i] ? (int)(unsigned)(packed[i] & 0xffffffffull) : 0;
  return 0;
}

}  // extern "C"
